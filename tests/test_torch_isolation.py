"""ultravox_torch and chip_smoke.py stand alone: no module imports jax or
the JAX package (the machine with the card has no JAX), nor ``transformers``,
``safetensors``, ``optax`` or ``orbax``; the checkpoint, streaming and
serving modules, the offline front doors, the tokenizer loader and the
training loop import and run without them (the loader needs only
``tokenizers`` and ``jinja2``, the training config ``yaml``, all on the
card's machine), HF ``datasets`` is imported in four functions only
(``data/datasets.py::_load_hf_dataset``, for HF-hosted sets, and the
dataset factory's ``AudioMixTask._pool_segments``,
``TimestampTask.map_split`` and ``main``), ``openai``, ``requests`` and
``huggingface_hub`` only inside the functions that call them, and
importing the package builds or loads no kernel. ``parallel/`` and ``evaluation/``
use ``torch.distributed`` and nothing of the above (the evaluation suite
scores WER with its own copy of Whisper's English normaliser); the
multi-process entry points join NCCL, never gloo, where CUDA is present
and the CPU was not asked for, and default to the card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "ultravox_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ultravox_tpu", "flax", "optax", "orbax", "transformers",
             "safetensors")
# the tokenizer loader's two packages and the training config's reader
# (PyYAML 6.0.3 on the card's machine, read there by the first chip call of
# the training loop's PR), all on the card's machine
ALLOWED_THIRD_PARTY = ("tokenizers", "jinja2", "yaml")
# (file, qualified function name) of each place the port imports HF ``datasets``
HF_DATASETS_SITES = (
    ("ultravox_torch/data/datasets.py", "_load_hf_dataset"),
    ("ultravox_torch/tools/ds_tool/ds_tool.py", "AudioMixTask._pool_segments"),
    ("ultravox_torch/tools/ds_tool/ds_tool.py", "TimestampTask.map_split"),
    ("ultravox_torch/tools/ds_tool/ds_tool.py", "main"),
)


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


def _hf_datasets_sites(path: Path):
    """(qualified function name or None) of each import of the top-level
    ``datasets``; a class's name qualifies its methods."""
    tree = ast.parse(path.read_text(), filename=str(path))
    sites = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = func
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = f"{func}.{child.name}" if func else child.name
            if isinstance(child, ast.Import) and any(
                    a.name.split(".")[0] == "datasets" for a in child.names):
                sites.append(func)
            elif (isinstance(child, ast.ImportFrom) and child.level == 0 and child.module
                  and child.module.split(".")[0] == "datasets"):
                sites.append(func)
            visit(child, inner)

    visit(tree, None)
    return sites


def test_hf_datasets_only_in_its_loader():
    found = {}
    for path in FILES:
        sites = _hf_datasets_sites(path)
        if sites:
            found[str(path.relative_to(ROOT))] = sites
    want = {}
    for file, func in HF_DATASETS_SITES:
        want.setdefault(file, []).append(func)
    assert found == want


def test_package_imports_without_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ultravox_tpu', 'triton', 'safetensors', 'transformers',"
        " 'optax', 'orbax', 'datasets', 'openai', 'requests', 'huggingface_hub'):\n"
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
        "import ultravox_torch.training.train\n"
        "import ultravox_torch.training.checkpoint\n"
        "import ultravox_torch.training.model_factory\n"
        "import ultravox_torch.evaluation.validate\n"
        "import ultravox_torch.models.data_proc\n"
        "import ultravox_torch.data.mds\n"
        "import ultravox_torch.data.registry\n"
        "import ultravox_torch.data.aug\n"
        "import ultravox_torch.tools.data_tool\n"
        "import ultravox_torch.tools.mds_tool\n"
        "import ultravox_torch.parallel\n"
        "import ultravox_torch.parallel.multihost\n"
        "import ultravox_torch.evaluation.eval\n"
        "import ultravox_torch.evaluation.voicebench\n"
        "from ultravox_torch.evaluation import string_metrics\n"
        "import ultravox_torch.utils.retry\n"
        "import ultravox_torch.evaluation.gpt_eval\n"
        "import ultravox_torch.tools.ds_tool\n"
        "import ultravox_torch.tools.ds_tool.caching\n"
        "import ultravox_torch.tools.ds_tool.tts\n"
        "import ultravox_torch.tools.ds_tool.ds_tool\n"
        "import ultravox_torch.tools.update_hf_models\n"
        "import ultravox_torch.training.prefetch_weights\n"
        "from ultravox_torch.tools.ds_tool.tts import AzureTts\n"
        "AzureTts()\n"
        "assert string_metrics.wer(['it costs $25'], ['It costs twenty-five dollars!']) == 0.0\n"
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


def test_training_loop_runs_without_jax_or_hf(tmp_path):
    """With JAX, the JAX package, ``transformers``, ``safetensors``,
    ``optax``, ``orbax`` and HF ``datasets`` blocked, the training CLI's
    ``main()`` trains 2 steps of ``test_train.yaml`` on the CPU (the
    tokenizer saved here beforehand with ``transformers``) and writes its
    config, log, checkpoint and export."""
    from tests.helpers import make_tiny_tokenizer

    make_tiny_tokenizer().save_pretrained(tmp_path / "tok")
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ultravox_tpu', 'triton', 'safetensors', 'transformers',"
        " 'optax', 'orbax', 'datasets'):\n"
        "    sys.modules[m] = None\n"
        "from ultravox_torch.training import train\n"
        "sys.argv = ['train', '--config_path', 'ultravox_torch/training/configs/test_train.yaml',"
        f" '--device', 'cpu', '--tokenizer_path', {str(tmp_path / 'tok')!r}, '--text_model', '',"
        f" '--output_dir', {str(out)!r}, '--report_logs_to', '[]']\n"
        "train.main()\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    assert sorted(os.listdir(out)) == ["checkpoint-2", "model.safetensors", "train_config.json",
                                       "train_log.jsonl"]
    with open(out / "train_log.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]


def _spy_init(monkeypatch, cuda: bool):
    """initialize_multihost's view of a machine with or without CUDA: the
    backend and init URL it asks for, and the card it binds first."""
    import torch.distributed as dist

    from ultravox_torch.parallel import mesh

    calls = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend, **kw))
    monkeypatch.setattr(mesh.torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: 8 if cuda else 0)
    monkeypatch.setattr(mesh.torch.cuda, "set_device", lambda i: calls.update(card=i))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    return mesh, calls


@pytest.mark.parametrize("launch", ["torchrun", "explicit"])
def test_initialize_multihost_never_picks_gloo_with_cuda(monkeypatch, launch):
    """With CUDA present the group is NCCL, each process bound to its card
    (cuda:LOCAL_RANK) before it joins; gloo only without CUDA; a plain
    single process joins nothing."""
    mesh, calls = _spy_init(monkeypatch, cuda=True)
    if launch == "torchrun":
        for k, v in dict(RANK="5", WORLD_SIZE="8", LOCAL_RANK="5", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT="29500").items():
            monkeypatch.setenv(k, v)
        mesh.initialize_multihost()
        want = dict(backend="nccl", init_method="env://", world_size=8, rank=5, card=5)
    else:
        mesh.initialize_multihost("10.0.0.1:1234", 4, 3)
        want = dict(backend="nccl", init_method="tcp://10.0.0.1:1234", world_size=4, rank=3,
                    card=3)
    assert calls == want

    mesh, calls = _spy_init(monkeypatch, cuda=False)
    mesh.initialize_multihost("file:///tmp/rendezvous", 2, 1)
    assert calls == dict(backend="gloo", init_method="file:///tmp/rendezvous", world_size=2,
                         rank=1)

    mesh, calls = _spy_init(monkeypatch, cuda=True)
    mesh.initialize_multihost()
    mesh.initialize_multihost(num_processes=1)
    assert calls == {}


def test_initialize_multihost_takes_the_backend_from_the_device(monkeypatch):
    """The backend follows the device the run asked for, not the machine:
    a run asked onto the CPU joins gloo even where CUDA is present (its
    tensors could not travel over NCCL), and one asked onto a card joins
    NCCL bound to cuda:LOCAL_RANK."""
    import torch

    mesh, calls = _spy_init(monkeypatch, cuda=True)
    mesh.initialize_multihost("file:///tmp/rendezvous", 2, 1, device="cpu")
    assert calls == dict(backend="gloo", init_method="file:///tmp/rendezvous", world_size=2,
                         rank=1)

    mesh, calls = _spy_init(monkeypatch, cuda=True)
    mesh.initialize_multihost("file:///tmp/rendezvous", 2, 1, device=torch.device("cuda"))
    assert calls == dict(backend="nccl", init_method="file:///tmp/rendezvous", world_size=2,
                         rank=1, card=1)


def test_multi_process_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The eval CLI, like training and validation, runs on the card unless
    asked for the CPU: without one it raises before loading anything."""
    import sys

    from ultravox_torch.evaluation import eval as teval

    monkeypatch.setattr(teval.collectives.dist, "is_initialized", lambda: False)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["eval", "--model", str(tmp_path), "--eval_sets",
                                      "[synthetic-asr]"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main()
