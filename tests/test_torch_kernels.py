"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode (``interpret=None`` picks it on the CPU).
Both get the same numpy inputs. Tolerances: fp32 1e-5 (the two differ only
in summation order); bf16 outputs within 2^-6 relative plus 2^-6 absolute
(a couple of bf16 ulps: rounding points are the same, but an fp32 sum in
another order can land an output on the other side of a bf16 rounding
boundary).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ultravox_torch.ops.kernels import fused_attention as tfa
from ultravox_torch.ops.kernels import layer_norm as tln
from ultravox_tpu.ops.pallas import fused_attention as jfa
from ultravox_tpu.ops.pallas import layer_norm as jln

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=1e-5, atol=1e-5) if name == "float32" else dict(rtol=2**-6, atol=2**-6)


def _j(a, jdt):
    return jnp.asarray(a).astype(jdt)


def _t(a, tdt):
    return torch.from_numpy(np.asarray(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _ln_inputs(D=128):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 128, D)).astype(np.float32) * 2 + 0.5
    s = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    b = (0.2 * rng.standard_normal(D)).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("D", [128, 768])  # 768: the encoder's width
@pytest.mark.parametrize("dt", list(DTYPES))
def test_layer_norm_matches_pallas(dt, D):
    tdt, jdt = DTYPES[dt]
    x, s, b = _ln_inputs(D)
    ref = jln.fused_layer_norm(_j(x, jdt), jnp.asarray(s), jnp.asarray(b))
    out = tln.fused_layer_norm(_t(x, tdt), _t(s, torch.float32), _t(b, torch.float32))
    assert out.dtype == tdt and out.shape == x.shape
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_qkv_head_matches_pallas(dt):
    tdt, jdt = DTYPES[dt]
    x, s, b = _ln_inputs()
    rng = np.random.default_rng(1)
    w = (0.1 * rng.standard_normal((128, 384))).astype(np.float32)
    pb = rng.standard_normal(384).astype(np.float32)
    ref = jfa.ln_qkv_head_fused(
        _j(x, jdt), jnp.asarray(s), jnp.asarray(b), _j(w, jdt), _j(pb, jdt), 64, block_t=128
    )
    out = tfa.ln_qkv_head_fused(
        _t(x, tdt), _t(s, torch.float32), _t(b, torch.float32), _t(w, tdt), _t(pb, tdt), 64
    )
    assert out.shape == (2, 6, 128, 64)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_qkv_head_matches_pallas_at_encoder_width(dt):
    """The whisper-small encoder's width: D 768 -> C 2304 in heads of 64,
    T 128. The CPU route is the plain version the card holds its kernels
    against."""
    tdt, jdt = DTYPES[dt]
    x, s, b = _ln_inputs(768)
    rng = np.random.default_rng(4)
    w = (0.03 * rng.standard_normal((768, 2304))).astype(np.float32)
    pb = (0.1 * rng.standard_normal(2304)).astype(np.float32)
    ref = jfa.ln_qkv_head_fused(
        _j(x, jdt), jnp.asarray(s), jnp.asarray(b), _j(w, jdt), _j(pb, jdt), 64, block_t=128
    )
    out = tfa.ln_qkv_head_fused(
        _t(x, tdt), _t(s, torch.float32), _t(b, torch.float32), _t(w, tdt), _t(pb, tdt), 64
    )
    assert out.shape == (2, 36, 128, 64) and out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


@pytest.mark.parametrize("latency_block", [0, 32])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_attention_headmajor_matches_pallas(dt, latency_block):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 6, 128, 64)).astype(np.float32)
    lens = np.array([100, 128], np.int32)
    ref = jfa.attention_headmajor(
        _j(qkv, jdt), jnp.asarray(lens), n_heads=2, latency_block=latency_block, n_chunks=4
    )
    out = tfa.attention_headmajor(
        _t(qkv, tdt), torch.from_numpy(lens), n_heads=2, latency_block=latency_block
    )
    assert out.shape == (2, 2, 128, 64)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


FA_CASES = {
    "lengths": dict(lengths=np.array([74, 90], np.int32)),
    "causal_offsets_gqa": dict(
        lengths=np.array([74, 90], np.int32), row_offsets=np.array([10, 26], np.int32),
        causal=True,
    ),
    "latency_block": dict(latency_block=16),
}


@pytest.mark.parametrize("case", list(FA_CASES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_fused_attention_matches_pallas(dt, case):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)  # GQA group 2
    v = rng.standard_normal((2, 128, 2, 64)).astype(np.float32)
    kw = FA_CASES[case]
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    ref = jfa.fused_attention(*(_j(a, jdt) for a in (q, k, v)), block_q=64, **jkw)
    out = tfa.fused_attention(*(_t(a, tdt) for a in (q, k, v)), **tkw)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never launches a kernel, so the counts do not move."""
    counters = [tln.fused_layer_norm, tfa.ln_qkv_head_fused, tfa.attention_headmajor,
                tfa.fused_attention]
    before = [f.launches for f in counters]
    x, s, b = _ln_inputs()
    tln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    qkv = torch.randn(1, 6, 16, 32)
    tfa.attention_headmajor(qkv, torch.tensor([16]), n_heads=2)
    tfa.fused_attention(qkv[:, :2].transpose(1, 2), qkv[:, 2:4].transpose(1, 2),
                        qkv[:, 4:].transpose(1, 2), causal=True)
    assert [f.launches for f in counters] == before
