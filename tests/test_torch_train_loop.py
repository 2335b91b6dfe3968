"""The port's ``train()`` against the JAX package's, on the CPU.

Both loops run ``test_train.yaml`` (tiny whisper + llama, ``synthetic-asr``,
the tiny tokenizer saved to a directory) from one parameter tree: the JAX
run's model factory output, handed to the port through
``models/weights.py::from_jax_params`` in place of its own draws. Compared:

- each logged step's ``grad_norm`` and ``param_norm`` within rtol 1e-5, and
  its ``loss`` within rtol 1e-5 plus atol 1e-6: the KL loss of a freshly
  initialised model is ~3e-4, a difference of two cross-entropies of
  ~log(384) = 6, so fp32 rounding alone leaves ~2e-7 of it;
- the output files, ``train_config.json`` (the port adds ``device``), and
  ``model.safetensors``: the same keys, values within atol 1e-6. The JAX
  export writes each linear weight's (in, out) buffer under the (out, in)
  shape (``safetensors.numpy`` takes a transposed view's raw memory), so its
  linear weights are read back as that buffer; the port's are the true
  transpose of its checkpoint's kernels;
- KL and CE; ``attn_impl: flash`` (the plain version of #13, the CPU route of
  the kernel wrapper) against the JAX loop at ``"xla"``, the same attention;
- the layouts the port raises ``ValueError`` for (more processes than the
  run has: pipeline and tensor stages included), before any work, and the
  card as the default device.

Gradient accumulation, resume, validation and the latency-block mask are in
``tests/test_torch_train_resume.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.models.weights import from_jax_params, read_safetensors
from ultravox_torch.training import config as tcfg
from ultravox_torch.training import train as ttrain
from ultravox_tpu.training import config as jcfg
from ultravox_tpu.training import train as jtrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YAML = os.path.join(ROOT, "ultravox_tpu", "training", "configs", "test_train.yaml")
PORT_YAML = os.path.join(ROOT, "ultravox_torch", "training", "configs", "test_train.yaml")
LOSS_RTOL, LOSS_ATOL, NORM_RTOL = 1e-5, 1e-6, 1e-5


def _argv(yaml, out, tok, overrides):
    argv = ["--config_path", yaml, "--output_dir", str(out), "--tokenizer_path", tok,
            "--text_model", ""]
    for k, v in overrides.items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    return argv


def run_jax(out, tok, **overrides):
    """The JAX train(); returns (config, its initial parameters as numpy)."""
    cfg = jcfg.get_train_config(_argv(JAX_YAML, out, tok, overrides))
    held = {}
    orig = jtrain.create_model_pack

    def pack(c):
        p = orig(c)
        held["params"] = jax.tree.map(np.array, p.params)  # before the loop donates them
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_model_pack", pack)
        jtrain.train(cfg)
    return cfg, held["params"]


def run_port(out, tok, params=None, **overrides):
    """The port's train() on the CPU, from ``params`` (a JAX tree as numpy)
    when given, else from its own model factory."""
    cfg = tcfg.get_train_config(_argv(PORT_YAML, out, tok, overrides) + ["--device", "cpu"])
    orig = ttrain.create_model_pack

    def pack(c):
        p = orig(c)
        if params is not None:
            p.params = from_jax_params(params, p.config, device="cpu")
        return p

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "create_model_pack", pack)
        ttrain.train(cfg)
    return cfg


def read_log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def assert_logs_match(jout, tout):
    j, t = read_log(jout), read_log(tout)
    assert [r["step"] for r in t] == [r["step"] for r in j] and j
    for a, b in zip(j, t):
        assert set(a) == set(b), (a, b)
        for k in a:
            if k in ("step", "samples_per_s"):
                continue
            loss = "loss" in k
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL if loss else NORM_RTOL,
                                       atol=LOSS_ATOL if loss else 0.0,
                                       err_msg=f"step {a['step']} {k}")


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    make_tiny_tokenizer().save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def kl_runs(tmp_path_factory, tokenizer_dir):
    base = tmp_path_factory.mktemp("kl")
    jc, params = run_jax(base / "jax", tokenizer_dir)
    tc = run_port(base / "port", tokenizer_dir, params)
    return jc, tc, params


def test_kl_loop_matches_jax(kl_runs):
    jc, tc, _ = kl_runs
    assert_logs_match(jc.output_dir, tc.output_dir)
    assert sorted(os.listdir(tc.output_dir)) == sorted(os.listdir(jc.output_dir))
    for name in ("train_config.json", "train_log.jsonl", "checkpoint-2", "model.safetensors"):
        assert os.path.exists(os.path.join(tc.output_dir, name)), name
    with open(os.path.join(jc.output_dir, "train_config.json")) as f:
        jrec = json.load(f)
    with open(os.path.join(tc.output_dir, "train_config.json")) as f:
        trec = json.load(f)
    assert trec.pop("device") == "cpu"
    jrec.pop("output_dir"), trec.pop("output_dir")
    assert trec == jrec


def test_export_matches_jax(kl_runs):
    jc, tc, _ = kl_runs
    jsd = read_safetensors(os.path.join(jc.output_dir, "model.safetensors"))
    tsd = read_safetensors(os.path.join(tc.output_dir, "model.safetensors"))
    assert sorted(tsd) == sorted(jsd)
    assert any(k.startswith("multi_modal_projector.") for k in tsd)
    state = torch.load(os.path.join(tc.output_dir, "checkpoint-2", "state.pt"), weights_only=True)
    for k, got in tsd.items():
        got = np.asarray(got)
        want = np.asarray(jsd[k])
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, k
        if got.ndim == 2:  # the JAX file holds the (in, out) buffer
            want = want.reshape(got.shape[::-1]).T
            leaf = k.replace("multi_modal_projector.", "projector/").replace(".weight", "/kernel")
            np.testing.assert_array_equal(got, state["trainable"][leaf].numpy().T)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)


def test_ce_loop_matches_jax(tmp_path, tokenizer_dir):
    jc, params = run_jax(tmp_path / "jax", tokenizer_dir, loss_function="ce")
    tc = run_port(tmp_path / "port", tokenizer_dir, params, loss_function="ce")
    assert_logs_match(jc.output_dir, tc.output_dir)
    assert read_log(tc.output_dir)[0]["loss"] > 1.0  # a cross-entropy, not a KL


def test_flash_loop_matches_xla(kl_runs, tmp_path, tokenizer_dir):
    jc, _, params = kl_runs
    from ultravox_torch.ops.kernels import flash_attention as fl

    before = (fl.flash_attention.launches, fl.flash_attention.bwd_launches)
    tc = run_port(tmp_path / "port", tokenizer_dir, params, attn_impl="flash")
    assert (fl.flash_attention.launches, fl.flash_attention.bwd_launches) == before  # plain route
    assert_logs_match(jc.output_dir, tc.output_dir)


@pytest.mark.parametrize("overrides,match", [
    ({"mesh_pipe": 2}, r"mesh \[1, 1, 1, 2\] needs more than the 1 available devices"),
    ({"mesh_pipe": 4}, r"mesh \[1, 1, 1, 4\] needs more than the 1 available devices"),
    ({"mesh_pipe": 2, "mesh_tensor": 2},
     r"mesh \[1, 1, 2, 2\] needs more than the 1 available devices"),
])
def test_single_process_only(tmp_path, tokenizer_dir, overrides, match):
    """A pipeline layout (4 stages as v0.6_llama3_70b_pipe_tpu.yaml asks;
    with tensor stages too) over fewer processes than it needs raises
    before any work, naming the process count; over processes enough it
    runs (tests/test_torch_parallel_pipe.py)."""
    with pytest.raises(ValueError, match=match):
        run_port(tmp_path / "out", tokenizer_dir, **overrides)
    assert not os.path.exists(tmp_path / "out")  # raised before any work


@pytest.mark.parametrize("overrides,match", [
    ({"num_processes": 2}, "world size and rank"),
    ({"mesh_data": 2}, "needs more than the 1 available devices"),
    ({"mesh_fsdp": 2}, "needs more than the 1 available devices"),
    ({"mesh_tensor": 2}, "needs more than the 1 available devices"),
])
def test_layouts_beyond_the_processes_raise(tmp_path, tokenizer_dir, overrides, match):
    """A layout that needs more processes than the run has raises
    ValueError before any work (a second process without its rank, a
    mesh larger than one process, tensor 2 included)."""
    with pytest.raises(ValueError, match=match):
        run_port(tmp_path / "out", tokenizer_dir, **overrides)
    assert not os.path.exists(tmp_path / "out")


def test_device_defaults_to_the_card(tmp_path, tokenizer_dir, monkeypatch):
    cfg = tcfg.get_train_config(_argv(PORT_YAML, tmp_path / "out", tokenizer_dir, {}))
    assert cfg.device is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg)
