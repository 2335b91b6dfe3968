"""The port's serve-and-score harness (``inference/run_serving_eval.py``)
against the JAX package's, on the CPU, fp32.

Both CLIs serve ``tests/assets/tiny_ultravox`` (with the tiny test
tokenizer beside it) from an HTTP server in their own process, drive it
through their ``OpenAIInference`` client and score ``synthetic-asr``
with their metric registries. The JAX CLI loads its weights and KV cache
in bf16; it runs here with fp32 in their place (its ``jnp.bfloat16`` and
its engine's cache dtype patched for the call), so that the two agree
token for token. Held: the printed scores, and every sample's question,
reference and generated answer in the two ``synthetic-asr.json`` files,
equal; ``start_server`` / ``wait_healthy`` answer ``/health``.
"""

import functools
import json
import os
import shutil
import sys
import urllib.request
from unittest import mock

import jax.numpy as jnp
import pytest

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.inference import run_serving_eval as trse
from ultravox_tpu.inference import run_serving_eval as jrse
from ultravox_tpu.inference.serving import engine as jengine

FIXTURE = "tests/assets/tiny_ultravox"
ARGS = ["--eval_sets", "[synthetic-asr]", "--num_samples", "4", "--batch_size", "2",
        "--max_tokens", "6", "--num_slots", "2", "--max_seq_len", "256"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    for name in ("config.json", "model.safetensors"):
        shutil.copy(os.path.join(FIXTURE, name), os.path.join(d, name))
    make_tiny_tokenizer().save_pretrained(d)
    return d


def _scores(out: str) -> dict:
    return json.loads(out[out.index("{"):])


@pytest.fixture(scope="module")
def runs(ckpt, tmp_path_factory):
    """(port's scores, port's output dir, JAX's scores, JAX's output dir)."""
    base = tmp_path_factory.mktemp("eval")
    port_dir, jax_dir = str(base / "port"), str(base / "jax")
    scores = trse.main(["--model", ckpt, "--device", "cpu", "--output_dir", port_dir] + ARGS)
    fp32_engine = functools.partial(jengine.ServingEngine, cache_dtype=jnp.float32)
    argv = ["run_serving_eval", "--model", ckpt, "--output_dir", jax_dir] + ARGS
    printed = []
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.object(jnp, "bfloat16", jnp.float32), \
            mock.patch.object(jengine, "ServingEngine", fp32_engine), \
            mock.patch("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a)))):
        jrse.main()
    return scores, port_dir, _scores(printed[-1]), jax_dir


def test_scores_match_jax(runs):
    scores, _, jax_scores, _ = runs
    assert scores == jax_scores
    assert scores["synthetic-asr"]["num_samples"] == 4


def test_every_sample_matches_jax(runs):
    _, port_dir, _, jax_dir = runs
    for name in ("synthetic-asr.json", "summary.json"):
        with open(os.path.join(port_dir, name)) as f:
            port = json.load(f)
        with open(os.path.join(jax_dir, name)) as f:
            want = json.load(f)
        assert port == want, name


def test_generated_answers_are_not_empty(runs):
    _, port_dir, _, _ = runs
    with open(os.path.join(port_dir, "synthetic-asr.json")) as f:
        samples = json.load(f)["samples"]
    assert len(samples) == 4 and any(s["generated_answer"] for s in samples)
    assert [s["index"] for s in samples] == [0, 1, 2, 3]


def test_start_server_answers_health(ckpt):
    server, engine, port = trse.start_server(ckpt, num_slots=2, max_seq_len=128, device="cpu")
    try:
        trse.wait_healthy(port)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
            assert json.load(r)["status"] == "ok"
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
