"""The port's last five kernel modules against the JAX package's Pallas
kernels, on the CPU.

``decode_matmul`` (bf16 and int8 + scale weights, fp32 and bf16 outputs, on
tests/test_pallas.py's shapes, and its ``supports`` gate), ``ln_matmul_gelu``,
``attn_out_proj_residual`` (and its bias-dtype error) and the profiling
probes ``attn_v2`` / ``attn_nt`` of ``scripts/profile_encoder_attn.py``
(loaded from the file, as that script is no module): on the CPU each wrapper
runs its plain version, and the JAX side runs its Pallas kernel in
interpret mode. Both get the same numpy inputs from seed 0. Tolerances as
tests/test_torch_kernels.py: fp32 1e-5 (summation order only); bf16 2^-6
relative plus 2^-6 absolute (an fp32 sum in another order can land an
output on the other side of a bf16 rounding boundary).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ultravox_torch.models import lora as tlora
from ultravox_torch.models.decoder import _quantize_kernel
from ultravox_torch.ops.kernels import decode_matmul as tdm
from ultravox_torch.ops.kernels import encoder_attn_probe as tprobe
from ultravox_torch.ops.kernels import fused_attention as tfa
from ultravox_torch.scripts import profile_encoder_attn as tprofile
from ultravox_tpu.ops.pallas import decode_matmul as jdm
from ultravox_tpu.ops.pallas import fused_attention as jfa

ROOT = Path(__file__).resolve().parent.parent
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=1e-5, atol=1e-5) if name == "float32" else dict(rtol=2**-6, atol=2**-6)


def _j(a, jdt):
    return jnp.asarray(a).astype(jdt)


def _t(a, tdt):
    return torch.from_numpy(np.array(a)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_probes():
    """scripts/profile_encoder_attn.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "profile_encoder_attn_reference", ROOT / "scripts" / "profile_encoder_attn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------
# decode_matmul
# --------------------------------------------------------------------------

DM_SHAPES = [(8, 256, 384), (8, 256, 1664), (1, 128, 256)]  # tests/test_pallas.py's


def _dm_inputs(M, K, N):
    """bf16-valued x and w, w's per-column int8 quantization and its scale."""
    rng = np.random.default_rng(0)
    x = np.array(_j(rng.standard_normal((M, K)), jnp.bfloat16).astype(jnp.float32))
    w = np.array(_j(0.05 * rng.standard_normal((K, N)), jnp.bfloat16).astype(jnp.float32))
    sc = np.abs(w).max(axis=0) / 127.0
    wq = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    return x, w, wq, sc


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("weight", ["bfloat16", "int8"])
@pytest.mark.parametrize("shape", DM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_matmul_matches_pallas(shape, weight, out):
    tout, jout = DTYPES[out]
    x, w, wq, sc = _dm_inputs(*shape)
    if weight == "int8":
        ref = jdm.decode_matmul(_j(x, jnp.bfloat16), jnp.asarray(wq), _j(sc, jnp.bfloat16),
                                out_dtype=jout, block_n=256)
        got = tdm.decode_matmul(_t(x, torch.bfloat16), torch.from_numpy(wq),
                                _t(sc, torch.bfloat16), out_dtype=tout)
    else:
        ref = jdm.decode_matmul(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), out_dtype=jout,
                                block_n=256)
        got = tdm.decode_matmul(_t(x, torch.bfloat16), _t(w, torch.bfloat16), out_dtype=tout)
    assert got.dtype == tout and got.shape == shape[::2]
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(out))


@pytest.mark.parametrize("shape, k, n", [
    ((2, 256), 256, 384), ((2, 16, 256), 256, 384), ((33, 256), 256, 384), ((4, 200), 200, 384),
    ((4, 256), 256, 1000), ((4,), 256, 384), ((32, 32768), 32768, 128),
])
def test_decode_matmul_supports_matches_reference(shape, k, n):
    """Each of the reference's conditions: rows (leading dims multiplied) at
    most 32, K and N multiples of 128, the activation within 2 MB."""
    assert tdm.supports(shape, k, n) == jdm.supports(shape, k, n)


@pytest.mark.parametrize("rows", [1, 4, 32])
def test_decode_matmul_plain_is_the_w8a16_product(rows):
    """The plain version is bit for bit lora.py's w8a16 branch on one int8
    projection, the product a later change may route to the kernel."""
    rng = np.random.default_rng(0)
    q, scale = _quantize_kernel(torch.from_numpy(0.02 * rng.standard_normal((512, 384))).float())
    p = {"kernel_q": q, "scale": scale}
    x = torch.from_numpy(rng.standard_normal((rows, 512))).to(torch.bfloat16)
    assert rows <= tlora.W8A16_MAX_ROWS
    assert torch.equal(tdm.decode_matmul(x, q, scale), tlora.proj_apply(x, p))


# --------------------------------------------------------------------------
# ln_matmul_gelu and attn_out_proj_residual
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_matmul_gelu_matches_pallas(dt):
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256, 128)).astype(np.float32) * 2 + 0.5
    s = (1 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    b = (0.2 * rng.standard_normal(128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, 256))).astype(np.float32)
    pb = (0.1 * rng.standard_normal(256)).astype(np.float32)
    ref = jfa.ln_matmul_gelu(_j(x, jdt), jnp.asarray(s), jnp.asarray(b), _j(w, jdt), _j(pb, jdt),
                             block_t=128)
    got = tfa.ln_matmul_gelu(_t(x, tdt), _t(s, torch.float32), _t(b, torch.float32), _t(w, tdt),
                             _t(pb, tdt))
    assert got.shape == (2, 256, 256) and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dt))


# #7's head layouts (B, H, T, Dh, M): 2 heads of 64 into 256, and 4 heads of
# 32 into 96 (K 128, three 32-column runs; the JAX kernel needs T % 128 == 0)
OUT_PROJ_LAYOUTS = {"h2": (2, 2, 128, 64, 256), "h4": (2, 4, 256, 32, 96)}


def _out_proj_inputs(layout="h2"):
    B, H, T, Dh, M = OUT_PROJ_LAYOUTS[layout]
    rng = np.random.default_rng(0)
    attn = rng.standard_normal((B, H, T, Dh)).astype(np.float32)
    w = (0.1 * rng.standard_normal((H, Dh, M))).astype(np.float32)
    b = (0.1 * rng.standard_normal(M)).astype(np.float32)
    x = rng.standard_normal((B, T, M)).astype(np.float32)
    return attn, w, b, x


@pytest.mark.parametrize("dt,layout", [(dt, "h2") for dt in DTYPES] + [(dt, "h4") for dt in DTYPES],
                         ids=list(DTYPES) + [f"{dt}-h4" for dt in DTYPES])
def test_attn_out_proj_residual_matches_pallas(dt, layout):
    tdt, jdt = DTYPES[dt]
    arrays = _out_proj_inputs(layout)
    B, _, T, _, M = OUT_PROJ_LAYOUTS[layout]
    ref = jfa.attn_out_proj_residual(*(_j(a, jdt) for a in arrays))
    got = tfa.attn_out_proj_residual(*(_t(a, tdt) for a in arrays))
    assert got.shape == (B, T, M) and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(ref), **_tol(dt))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_attn_out_proj_residual_equals_the_encoders_einsum(dt):
    """The kernel's function is the out-projection the port's fused encoder
    computes (whisper_encoder._encoder_layer's einsum + bias, then the
    residual)."""
    tdt, _ = DTYPES[dt]
    attn, w, b, x = (_t(a, tdt) for a in _out_proj_inputs())
    einsum = x + (torch.einsum("bhtd,hdm->btm", attn, w) + b)
    np.testing.assert_allclose(_np(tfa.attn_out_proj_residual(attn, w, b, x)), _np(einsum),
                               **_tol(dt))


def test_attn_out_proj_residual_raises_on_a_bias_of_another_dtype():
    attn, w, b, x = _out_proj_inputs()
    with pytest.raises(ValueError):
        jfa.attn_out_proj_residual(*(_j(a, jnp.bfloat16) for a in (attn, w)), jnp.asarray(b),
                                   _j(x, jnp.bfloat16))
    with pytest.raises(ValueError, match="bias dtype"):
        tfa.attn_out_proj_residual(*(_t(a, torch.bfloat16) for a in (attn, w)),
                                   torch.from_numpy(b), _t(x, torch.bfloat16))


# --------------------------------------------------------------------------
# the encoder-attention probes
# --------------------------------------------------------------------------


def _probe_inputs():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((2, 128, 2, 64)).astype(np.float32) * 0.6 for _ in range(3))


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("exp", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", [[128, 77], None], ids=["lengths", "no-mask"])
@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
def test_probe_matches_pallas(probe, lengths, exp, block_q):
    """bf16 inputs, as the probes run; the bf16 exponent's rounding is the
    same on both sides, so the bf16 tolerance covers both exponents."""
    q, k, v = _probe_inputs()
    jlens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tlens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    ref = getattr(_jax_probes(), probe)(
        *(_j(a, jnp.bfloat16) for a in (q, k, v)), jlens, scale=64**-0.5, block_q=block_q,
        exp_dtype=DTYPES[exp][1])
    got = getattr(tprobe, probe)(
        *(_t(a, torch.bfloat16) for a in (q, k, v)), tlens, scale=64**-0.5, block_q=block_q,
        exp_dtype=DTYPES[exp][0])
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), **_tol("bfloat16"))


@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
def test_probe_in_fp32_matches_pallas(probe):
    q, k, v = _probe_inputs()
    lens = [128, 77]
    ref = getattr(_jax_probes(), probe)(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(lens, jnp.int32), scale=64**-0.5,
        block_q=64, exp_dtype=jnp.float32)
    got = getattr(tprobe, probe)(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.tensor(lens), scale=64**-0.5,
        block_q=64, exp_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(ref), **_tol("float32"))


@pytest.mark.parametrize("probe", ["attn_v2", "attn_nt"])
def test_probe_raises_when_block_q_does_not_divide_t(probe):
    """The reference's grid T // block_q would leave the last rows unwritten."""
    q = torch.zeros((1, 100, 2, 64))
    with pytest.raises(ValueError, match="block_q"):
        getattr(tprobe, probe)(q, q, q, scale=0.125, block_q=64)


def test_probe_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprofile.run()


def test_probe_entry_point_runs_the_references_variants():
    """The entry point's variants are the reference main's, in its order,
    at its shape."""
    assert [v[0] for v in tprofile.VARIANTS] == [
        f"v2 bq={bq} exp={tag}" for bq in (500, 1500) for tag in ("fp32", "bf16")
    ] + [f"no-transpose bq={bq} exp={tag}" for bq, tag in ((1500, "fp32"), (1500, "bf16"),
                                                          (500, "fp32"))] + ["v2 no-mask exp=fp32"]
    assert (tprofile.B, tprofile.T, tprofile.H, tprofile.D) == (8, 1500, 20, 64)
    assert tprofile.GFLOP == pytest.approx(92.16)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never launches a kernel, so the counts do not move."""
    counters = [tdm.decode_matmul, tfa.ln_matmul_gelu, tfa.attn_out_proj_residual,
                tprobe.attn_v2, tprobe.attn_nt]
    before = [f.launches for f in counters]
    x, w, wq, sc = _dm_inputs(2, 128, 128)
    tdm.decode_matmul(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(sc))
    a = torch.randn(1, 2, 16, 64)
    tfa.attn_out_proj_residual(a, torch.randn(2, 64, 32), torch.randn(32), torch.randn(1, 16, 32))
    tfa.ln_matmul_gelu(torch.randn(1, 16, 32), torch.ones(32), torch.zeros(32),
                       torch.randn(32, 64), torch.zeros(64))
    q = a.transpose(1, 2)
    tprobe.attn_v2(q, q, q, scale=0.125, block_q=16)
    tprobe.attn_nt(q, q, q, scale=0.125, block_q=16)
    assert [f.launches for f in counters] == before
