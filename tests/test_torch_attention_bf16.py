"""The plain versions of ``attention_headmajor``, ``fused_attention`` and the
``attn_v2`` / ``attn_nt`` probes against the Pallas kernels in bf16.

On the card the bf16 tensor-core kernel (``csrc/attention_mma.cuh``) is held
against ``attention_plain`` and ``attn_probe_plain`` (``chip_smoke.py``
phase 2, ``tests/test_torch_cuda.py``); this file holds those plain
versions against the reference, the Pallas kernels in interpret mode with
64-row query blocks (the card's tile height: ``block_q=64``, or for
``attention_headmajor`` chunks of 64 rows), so the chain from the kernel to
the reference is closed in the working dtype. Inputs are bf16 from one
numpy seed, given to both sides; D is 64 and 128. Cases: ``attention_headmajor``
with lengths and the latency block; ``fused_attention`` with Tq != S, causal
+ row offsets + GQA 4 at a T that is no multiple of 64, a scratch-like cache
of 256 slots with 40 valid keys, and rows of length 0; both probes with the
bf16 exponent (and the fp32 one), one row of length 0.

Tolerance: the card's bounds for the kernel against the plain version,
4 * 2^-8 * max|ref| per element (4 bf16 ulps of the largest value) and a
relative RMS error of 2^-10 over the tensor. Both sides round at the same
points (bf16 probabilities before the PV product) and sum in fp32, but in
another order, so an element near a bf16 rounding boundary may land one ulp
apart.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe
from ultravox_torch.ops.kernels import fused_attention as tfa
from ultravox_tpu.ops.pallas import fused_attention as jfa

ROOT = Path(__file__).resolve().parent.parent
RMS_TOL = 2.0**-10


@functools.lru_cache(maxsize=None)
def _jax_probes():
    """scripts/profile_encoder_attn.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "profile_encoder_attn_reference_bf16", ROOT / "scripts" / "profile_encoder_attn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, ref):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape and np.isfinite(got).all()
    tol = 4 * 2.0**-8 * float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    rms = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
    assert err <= tol, f"max abs error {err} > {tol}"
    assert rms <= RMS_TOL, f"relative RMS error {rms} > {RMS_TOL}"


HEADMAJOR_CASES = [
    dict(name="lengths+latency", lengths=(128, 77), latency_block=16),
    dict(name="lengths+zero-length-row", lengths=(0, 101), latency_block=0),
]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", HEADMAJOR_CASES, ids=[c["name"] for c in HEADMAJOR_CASES])
def test_attention_headmajor_plain_matches_pallas_in_bf16(case, D):
    """The packed (B, 3H, T, D) layout, T 128 in two 64-row chunks."""
    B, H, T = 2, 3, 128
    (qkv,) = _inputs(D, (B, 3 * H, T, D))
    jqkv, tqkv = _bf16(qkv)
    lens = np.asarray(case["lengths"], np.int32)
    ref = jfa.attention_headmajor(jqkv, jnp.asarray(lens), n_heads=H,
                                  latency_block=case["latency_block"], n_chunks=2,
                                  interpret=True)
    got = tfa.attention_headmajor(tqkv, torch.from_numpy(lens), n_heads=H,
                                  latency_block=case["latency_block"])
    assert got.dtype == torch.bfloat16
    _close(got, ref)


# (name, Tq, S, H, Hkv, lengths, row offsets, causal, latency block)
FUSED_CASES = [
    ("causal+offsets-gqa4-T77-S200", 77, 200, 8, 2, (120, 200), (43, 123), True, 0),
    ("scratch-S256-40-valid", 24, 256, 8, 2, (40, 40), (16, 16), True, 0),
    ("zero-length-row-T77-S130", 77, 130, 4, 4, (0, 130), None, False, 0),
    ("lengths+latency-T100-S160", 100, 160, 4, 1, (160, 33), None, False, 16),
]


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_fused_attention_plain_matches_pallas_in_bf16(case, D):
    """(B, T, H, D) queries against (B, S, Hkv, D) keys and values."""
    _, Tq, S, H, Hkv, lengths, offsets, causal, lb = case
    B = 2
    q, k, v = _inputs(Tq + D, (B, Tq, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    lens = np.asarray(lengths, np.int32)
    offs = np.asarray(offsets, np.int32) if offsets is not None else None
    ref = jfa.fused_attention(jq, jk, jv, jnp.asarray(lens),
                              None if offs is None else jnp.asarray(offs), causal=causal,
                              latency_block=lb, block_q=64, interpret=True)
    got = tfa.fused_attention(tq, tk, tv, torch.from_numpy(lens),
                              None if offs is None else torch.from_numpy(offs), causal=causal,
                              latency_block=lb)
    assert got.dtype == torch.bfloat16
    _close(got, ref)


@pytest.mark.parametrize("exp", ["bfloat16", "float32"])
@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
def test_probe_plain_matches_pallas_in_bf16(probe, exp):
    """T 128 = S in 64-row blocks, one row of length 0 (every logit
    NEG_INF: the row averages v over all keys)."""
    q, k, v = (x * 0.6 for x in _inputs(7, *[(2, 128, 3, 64)] * 3))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    lens = np.asarray((0, 90), np.int32)
    jexp, texp = (jnp.bfloat16, torch.bfloat16) if exp == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    ref = getattr(_jax_probes(), probe)(jq, jk, jv, jnp.asarray(lens), scale=64**-0.5,
                                        block_q=64, exp_dtype=jexp)
    got = getattr(tprobe, probe)(tq, tk, tv, torch.from_numpy(lens), scale=64**-0.5,
                                 block_q=64, exp_dtype=texp)
    assert got.dtype == torch.bfloat16
    _close(got, ref)
