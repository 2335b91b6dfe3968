"""The plain reference against the port's plain CPU paths at a tiny size
(float32): the Whisper tower, the projector, the mistral and qwen3
decoders with audio spliced in, and the KL rows. And the reference's
isolation: it imports nothing of the program."""

import ast
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uvbench import program, testing, weights
from uvbench.reference import plain

HERE = Path(__file__).resolve().parent
TOL = 2e-5


def _config(family: str) -> dict:
    c = copy.deepcopy(testing.TINY_CONFIG)
    if family == "qwen3":
        c.update(model_type="qwen3", rms_norm_eps=1e-06, num_attention_heads=8)
        c["projector"]["projector_ln_mid"] = True
        c["audio_lora"] = {"r": 4, "lora_alpha": 8, "target_modules": ["q_proj", "v_proj"]}
    return c


def _close(a, b):
    a, b = a.double(), b.double()
    assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("family", ["mistral", "qwen3"])
def test_reference_matches_the_port_on_the_cpu(family):
    from ultravox_torch.models import decoder, projector, ultravox, whisper_encoder

    c = _config(family)
    m = weights.dims(c)
    cfg = program.program_config(c)
    w = weights.make(c, 2**31 + 5, "cpu", fused=family == "mistral", dtype=torch.float32)
    if m.lora_r:  # a trained adapter, so the comparison sees it
        for n in ("q", "v"):
            w[f"enc.{n}.lora_b"].normal_(0.0, 0.05)
    tree = program.program_tree(w, c)
    frames = 96
    mel = torch.randn(m.n_mels, frames, generator=torch.Generator().manual_seed(1))
    enc_port = whisper_encoder.encoder_forward(
        tree["audio_tower"], cfg.audio_config, mel[None], torch.tensor([frames]))[0]
    enc_ref = plain.encoder(w, m, mel, lora=bool(m.lora_r))
    _close(enc_port, enc_ref)
    audio_port = projector.projector_forward(tree["projector"], cfg, enc_port[None])[0]
    audio_ref = plain.projector(w, m, enc_ref)
    _close(audio_port, audio_ref)

    ids = torch.randint(3, m.V, (40,), generator=torch.Generator().manual_seed(2))
    start = 5
    n_audio = audio_ref.shape[0]
    batch = {
        "audio_values": mel[None], "audio_lens": torch.tensor([frames], dtype=torch.int32),
        "audio_token_start_idx": torch.tensor([start], dtype=torch.int32),
        "audio_token_len": torch.tensor([n_audio], dtype=torch.int32),
        "audio_chunk_batch_idx": torch.zeros(1, dtype=torch.int32),
    }
    emb = ultravox.ultravox_embed(tree, cfg, ids[None], batch)
    T = ids.numel()
    logits_port, _ = decoder.decoder_forward(
        tree["language_model"], cfg.text_config, inputs_embeds=emb,
        positions=torch.arange(T)[None], kv_valid_len=torch.tensor([T]))
    x = plain.embed(w, m, ids, audio_ref, start)
    logits_ref = plain.head(w, m, plain.decoder_hidden(w, m, x))
    _close(logits_port[0], logits_ref)

    served = logits_ref[-4:].argmax(-1)
    assert float(plain.gaps(logits_ref[-4:], served).max()) == 0.0


def test_kl_rows_match_the_port():
    from ultravox_torch.models.ultravox import _kl_rows

    g = torch.Generator().manual_seed(3)
    s, t = torch.randn(6, 50, generator=g), torch.randn(6, 50, generator=g)
    _close(_kl_rows(s, t, 2.0), plain.kl_rows(s, t, 2.0))


def test_fp8_control_rounds_more_than_bf16():
    g = torch.Generator().manual_seed(4)
    x, W = torch.randn(64, 256, generator=g), torch.randn(256, 128, generator=g) * 0.02
    exact = x @ W
    bf16 = (x.bfloat16() @ W.bfloat16()).float()
    fp8 = plain.FP8.mm(x, W)
    err = [float((y - exact).norm() / exact.norm()) for y in (bf16, fp8)]
    assert err[1] > 4 * err[0]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = list((HERE / "reference").glob("*.py")) + [HERE / "weights.py"]
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("ultravox_torch", "ultravox_tpu", "jax", "jaxlib", "flax"), (f, name)
    reached = {n.split(".")[0] for f in files for n in _imports(f)}
    assert reached - set(sys.stdlib_module_names) <= {"numpy", "torch", "uvbench"}


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for f in HERE.rglob("*.py"):
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "ultravox_tpu"), (f, name)


def test_weights_are_the_same_from_the_same_seed():
    c = _config("qwen3")
    a = weights.make(c, 9, "cpu", fused=False, dtype=torch.float32)
    b = weights.make(c, 9, "cpu", fused=False, dtype=torch.float32)
    d = weights.make(c, 10, "cpu", fused=False, dtype=torch.float32)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dec.q"], d["dec.q"])
    np.testing.assert_array_equal(a["enc.q.lora_a"].numpy(),
                                  b["enc.q.lora_a"].numpy())
