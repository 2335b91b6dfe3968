"""The standalone torch model code shipped into published checkpoints.

``tools/publish.py::save_pretrained(include_code=True)`` copies these
files into the checkpoint directory and points ``auto_map`` in its
``config.json`` at them, so the directory loads with
``transformers.AutoModel.from_pretrained(dir, trust_remote_code=True)``.
They run on the consumer's side and import ``transformers``, which this
package never does: they are kept as data (``<name>.py.txt``), never
imported here, and written out as ``<name>.py``. They are byte-equal to
the hub code of the JAX package, so a checkpoint published by either
package carries the same code.
"""

import os

HUB_CODE_DIR = os.path.dirname(os.path.abspath(__file__))
HUB_CODE_FILES = (
    "ultravox_config.py",
    "ultravox_model.py",
    "ultravox_processing.py",
    "ultravox_tokenizer.py",
    "ultravox_pipeline.py",
)
STORED_SUFFIX = ".txt"  # each file's name here: <name>.py.txt

AUTO_MAP = {
    "AutoConfig": "ultravox_config.UltravoxConfig",
    "AutoModel": "ultravox_model.UltravoxModel",
    "AutoProcessor": "ultravox_processing.UltravoxProcessor",
}
