"""``flash_attention``'s plain version against the Pallas kernel in bf16.

On the card the bf16 tensor-core kernels are held against ``_FlashPlain``
(``chip_smoke.py`` phase 2, ``tests/test_torch_cuda.py``); this file holds
``_FlashPlain`` against the reference, the Pallas kernel in interpret mode
with ``block_q=64`` (the card's tile height), so the chain from the kernel
to the reference is closed in the working dtype too. Inputs are bf16 from
one numpy seed, given to both sides; B 2, T 77 (a whole 64-row tile and a
ragged one), H 8 over Hkv 2 (GQA 4), D 64 and 128, every mask of the
reference's own tests: lengths, causal, a window with padding rows that see
no key, the latency block, and a row of length 0.

Tolerance: the card's bounds for the kernel against the plain version,
4 * 2^-8 * max|ref| per element (4 bf16 ulps of the largest value) and a
relative RMS error of 2^-10 over the tensor. Both sides round at the same
points (bf16 probabilities before the PV product, ds * scale before dq and
dk) and sum in fp32, but in another order, so an element near a bf16
rounding boundary may land one ulp apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ultravox_torch.ops.kernels import flash_attention as tfl
from ultravox_tpu.ops.pallas import flash_attention as jfl

B, T, H, HKV = 2, 77, 8, 2
RMS_TOL = 2.0**-10

CASES = [
    dict(name="plain", lengths=None, causal=False, window=0, latency_block=0),
    dict(name="lengths", lengths=(77, 30), causal=False, window=0, latency_block=0),
    dict(name="causal", lengths=None, causal=True, window=0, latency_block=0),
    dict(name="causal+len+win", lengths=(60, 77), causal=True, window=9, latency_block=0),
    dict(name="latency", lengths=(77, 41), causal=False, window=0, latency_block=16),
    dict(name="zero-length-row", lengths=(0, 77), causal=True, window=0, latency_block=0),
]


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, HKV, D), (B, T, HKV, D), (B, T, H, D))]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_flash_attention_plain_matches_pallas_in_bf16(case, D):
    q, k, v, dout = _inputs(D, seed=D)
    lens = np.asarray(case["lengths"], np.int32) if case["lengths"] is not None else None
    kw = dict(causal=case["causal"], window=case["window"], latency_block=case["latency_block"])

    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    o_j, vjp = jax.vjp(
        lambda q_, k_, v_: jfl.flash_attention(
            q_, k_, v_, None if lens is None else jnp.asarray(lens), block_q=64,
            interpret=True, **kw),
        jq, jk, jv)
    g_j = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    o_t = tfl.flash_attention(tq, tk, tv, None if lens is None else torch.from_numpy(lens), **kw)
    o_t.backward(torch.from_numpy(dout).to(torch.bfloat16))
    assert o_t.dtype == torch.bfloat16

    for what, got, ref in zip(("out", "dq", "dk", "dv"), (o_t, tq.grad, tk.grad, tv.grad),
                              (o_j, *g_j)):
        got, ref = _f32(got), _f32(ref)
        assert got.shape == ref.shape and np.isfinite(got).all(), what
        tol = 4 * 2.0**-8 * float(np.abs(ref).max())
        err = float(np.abs(got - ref).max())
        rms = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
        assert err <= tol, f"{what}: max abs error {err} > {tol}"
        assert rms <= RMS_TOL, f"{what}: relative RMS error {rms} > {RMS_TOL}"
