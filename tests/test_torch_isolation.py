"""ultravox_torch and chip_smoke.py stand alone: no module imports jax or
the JAX package (the machine with the card has no JAX), nor ``transformers``
or ``safetensors``; the checkpoint, streaming and serving modules, the
offline front doors and the tokenizer loader import and run without them
(the loader needs only ``tokenizers`` and ``jinja2``, which the card's
machine has), and importing the package builds or loads no kernel."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ultravox_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ultravox_tpu", "flax", "optax", "transformers", "safetensors")
# the tokenizer loader's two packages, both on the card's machine
ALLOWED_THIRD_PARTY = ("tokenizers", "jinja2")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ultravox_tpu', 'triton', 'safetensors', 'transformers'):\n"
        "    sys.modules[m] = None\n"
        "import ultravox_torch\n"
        "import ultravox_torch.inference.engine\n"
        "import ultravox_torch.models.weights\n"
        "import ultravox_torch.inference.ultravox_infer\n"
        "import ultravox_torch.tools.publish\n"
        "import ultravox_torch.inference.serving.engine\n"
        "import ultravox_torch.inference.streaming\n"
        "import ultravox_torch.inference.serving.api_server\n"
        "import ultravox_torch.inference.serving.websocket\n"
        "import ultravox_torch.inference.serving.demo_page\n"
        "import ultravox_torch.utils.vad\n"
        "import ultravox_torch.utils.audio\n"
        "import ultravox_torch.data.sample\n"
        "import ultravox_torch.models.processor\n"
        "import ultravox_torch.models.tokenizer\n"
        "import ultravox_torch.inference.base\n"
        "import ultravox_torch.inference.infer\n"
        "import ultravox_torch.pipeline\n"
        "import ultravox_torch.tools.infer_api\n"
        "from ultravox_torch.inference.serving.api_server import build_api, main, make_server\n"
        "from ultravox_torch.inference.ultravox_infer import UltravoxInference\n"
        "from ultravox_torch.inference.serving.engine import _ngram_drafts, _spec_decode_block\n"
        "from ultravox_torch.models.decoder import segmented_spec_scan\n"
        "from ultravox_torch.ops.sampling import spec_accept_slots\n"
        "from ultravox_torch.ops.kernels import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
        "assert not any(m.startswith('ultravox_tpu') or m == 'jax' for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_tokenizer_loader_and_front_doors_run_without_transformers(tmp_path):
    """With ``transformers``, ``safetensors``, JAX and the JAX package
    blocked, the tokenizer loader reads a saved tokenizer (written here
    beforehand with ``transformers``) and renders its chat template, and
    ``UltravoxInference`` serves text on the CPU from a checkpoint
    directory."""
    import shutil

    from tests.helpers import make_tiny_tokenizer

    make_tiny_tokenizer().save_pretrained(tmp_path)
    for name in ("config.json", "model.safetensors"):
        shutil.copy(ROOT / "tests" / "assets" / "tiny_ultravox" / name, tmp_path / name)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ultravox_tpu', 'triton', 'safetensors', 'transformers'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from ultravox_torch.models.tokenizer import load_tokenizer\n"
        "from ultravox_torch.inference.ultravox_infer import UltravoxInference\n"
        "from ultravox_torch.data.sample import VoiceSample\n"
        f"tok = load_tokenizer({str(tmp_path)!r})\n"
        "s = tok.apply_chat_template([{'role': 'user', 'content': 'hi'}], tokenize=False,"
        " add_generation_prompt=True)\n"
        "assert s.endswith('<|start|>assistant\\n'), s\n"
        f"inf = UltravoxInference({str(tmp_path)!r}, dtype=torch.float32, max_cache_len=64,"
        " device='cpu')\n"
        "out = inf.infer(VoiceSample.from_prompt('hello world'), max_tokens=4)\n"
        "assert out.output_tokens > 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    for mod in ALLOWED_THIRD_PARTY:
        assert mod not in FORBIDDEN
