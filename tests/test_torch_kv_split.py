"""The split KV kernel's arithmetic, emulated on the CPU, against the TPU kernels.

On the card ``decode_attention`` and ``segment_tail_attention`` run one
kernel (``ultravox_torch/ops/kernels/csrc/kv_split.cuh``) that splits each
row's visible keys (prompt cache, then tail) across a cluster of NS blocks
and merges the blocks' partial softmax states (m, z, acc) in rank order.
The plain versions with ``softmax=split_softmax_plain`` emulate that split
and merge; here they are held against the Pallas kernels in interpret mode
(``block_s=64``, the JAX package's own CPU route; nothing in ultravox_tpu
changes) at NS 1, 2, 5 and 8, on rows that leave ranks empty, splits that
fall inside the tail, windows and a row of length 0.

Tolerances, those of test_torch_decode.py: fp32 2e-5 absolute (summation
order only); bf16 2^-6 relative plus 2^-6 absolute. A merge that drops the
exp(m_i - m) rescale must fail the same comparison.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ultravox_torch.ops.kernels import decode_attention as tda
from ultravox_torch.ops.kernels import segment_attention as tsa
from ultravox_tpu.ops.pallas import decode_attention as jda
from ultravox_tpu.ops.pallas import segment_attention as jsa

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPLITS = [1, 2, 5, 8]

# decode: GQA 4 against a 192-slot slab; row 0 is empty, row 1 (5 keys)
# leaves every rank but 0 empty, row 3 spans 5 ranks of 32 at NS 8
DEC = dict(B=4, S=192, H=8, Hkv=2, D=64, lens=[0, 5, 40, 160])
# segment: layer 1 of a 2-layer 64-slot cache plus a 24-slot tail; at NS 2
# and T = 1, row 1's 30 keys (9 prompt keys, tail slots 0-20) split at tail slot 7
SEG = dict(L=2, B=4, S=64, Hkv=2, G=2, D=64, Ts=24, lens=[0, 9, 40, 64], written=[5, 20, 3, 20])


def _tol(dt):
    return dict(rtol=0, atol=2e-5) if dt == "float32" else dict(rtol=2**-6, atol=2**-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _decode_inputs():
    rng = np.random.default_rng(11)
    B, S, H, Hkv, D = (DEC[k] for k in ("B", "S", "H", "Hkv", "D"))
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            np.array(DEC["lens"], np.int32))


@functools.lru_cache(maxsize=None)
def _decode_ref(dt, window):
    """The Pallas decode kernel in interpret mode, as numpy fp32."""
    q, k, v, lens = _decode_inputs()
    jdt = DTYPES[dt][1]
    out = jda.decode_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                               jnp.asarray(lens), window, block_s=64, interpret=True)
    return _np(out)


def _decode_split(dt, window, ns):
    tdt = DTYPES[dt][0]
    q, k, v, lens = _decode_inputs()
    return tda.decode_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(lens), window,
        scale=DEC["D"] ** -0.5, softmax=functools.partial(tda.split_softmax_plain, ns=ns))


@functools.lru_cache(maxsize=None)
def _segment_inputs(T):
    rng = np.random.default_rng(12 + T)
    L, B, S, Hkv, G, D, Ts = (SEG[k] for k in ("L", "B", "S", "Hkv", "G", "D", "Ts"))
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    written = np.minimum(np.array(SEG["written"], np.int32), Ts - T)
    return (r(B, T, Hkv * G, D), r(L, B, S, Hkv, D), r(L, B, S, Hkv, D), r(B, Ts, Hkv, D),
            r(B, Ts, Hkv, D), np.array(SEG["lens"], np.int32), written)


@functools.lru_cache(maxsize=None)
def _segment_ref(dt, T, window):
    q, kc, vc, tk, tv, lens, written = _segment_inputs(T)
    jdt = DTYPES[dt][1]
    f = lambda a: jnp.asarray(a).astype(jdt)  # noqa: E731
    out = jsa.segment_tail_attention(
        f(q), f(kc), f(vc), jnp.asarray(1, jnp.int32), jnp.asarray(lens), f(tk), f(tv),
        jnp.asarray(written), window, block_s=64, interpret=True)
    return _np(out)


def _segment_split(dt, T, window, ns):
    tdt = DTYPES[dt][0]
    q, kc, vc, tk, tv, lens, written = _segment_inputs(T)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    return tsa.segment_tail_attention_plain(
        t(q), t(kc), t(vc), 1, torch.from_numpy(lens), t(tk), t(tv), torch.from_numpy(written),
        window, scale=SEG["D"] ** -0.5, softmax=functools.partial(tda.split_softmax_plain, ns=ns))


@pytest.mark.parametrize("ns", SPLITS)
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_split_matches_pallas(dt, window, ns):
    """Ragged rows (0, 5, 40 and 160 of 192 slots), GQA 4."""
    out = _decode_split(dt, window, ns)
    assert out.dtype == DTYPES[dt][0] and tuple(out.shape) == (DEC["B"], DEC["H"], DEC["D"])
    np.testing.assert_allclose(_np(out), _decode_ref(dt, window), **_tol(dt))
    assert not _np(out)[0].any()  # the row of length 0 gives 0


@pytest.mark.parametrize("ns", SPLITS)
@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_split_matches_pallas(dt, T, window, ns):
    """T queries against the prompt cache at layer 1 plus the tail; prompt
    lengths 0..S, 3..20 tail slots written before."""
    out = _segment_split(dt, T, window, ns)
    np.testing.assert_allclose(_np(out), _segment_ref(dt, T, window), **_tol(dt))


def _ranks_of(masks, ns):
    return [r.numpy() for r in tda.key_ranks(masks, ns)]


def test_split_layout_has_empty_ranks_and_tail_splits():
    """The cases above exercise what they claim: ranks left empty by short
    rows, a split inside the tail, nothing for a row of length 0; every
    rank's share is a multiple of the granule but the last."""
    S = DEC["S"]
    n = torch.tensor(DEC["lens"])[:, None]
    (dec,) = _ranks_of([(torch.arange(S)[None] < n)[:, None, None]], 8)
    assert (dec[0] == -1).all()  # length 0: no rank reads anything
    assert set(dec[1][dec[1] >= 0]) == {0}  # 5 keys: ranks 1-7 empty
    assert set(dec[3][dec[3] >= 0]) == {0, 1, 2, 3, 4}  # 160 keys: shares of 32
    counts = np.bincount(dec[3][dec[3] >= 0])
    assert (counts[:-1] % tda.SPLIT_GRANULE == 0).all()

    # segment, T = 1, no window: prompt [0, n), tail [0, written + 1)
    Ts = SEG["Ts"]
    lens, written = torch.tensor(SEG["lens"]), torch.tensor(SEG["written"])
    ok_p = (torch.arange(SEG["S"])[None] < lens[:, None])[:, None, None, None]
    ok_t = (torch.arange(Ts)[None] <= written[:, None])[:, None, None, None]
    prompt, tail = _ranks_of([ok_p, ok_t], 2)
    # row 1: 9 prompt keys + 21 tail slots = 30 keys, shares of 16: rank 1
    # starts at tail slot 7
    assert set(prompt[1][prompt[1] >= 0]) == {0}
    assert list(tail[1][:21]) == [0] * 7 + [1] * 14
    # row 0 (no prompt) reads only its tail
    assert (prompt[0] == -1).all() and (tail[0][:6] >= 0).all()


def _merge_without_rescale(parts, q_dtype):
    """A planted fault: the partial sums added without exp(m_i - m)."""
    z = sum(zi for _, zi, _ in parts)
    acc = sum(ai for _, _, ai in parts)
    return (acc / torch.clamp(z, min=1e-30)).to(q_dtype)


@pytest.mark.parametrize("ns", [2, 5, 8])
def test_a_merge_without_the_rescale_fails(monkeypatch, ns):
    """The comparisons above catch a merge that skips the rescale, in fp32
    for the decode and the segment case."""
    monkeypatch.setattr(tda, "merge_partials_plain", _merge_without_rescale)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(_decode_split("float32", 0, ns)),
                                   _decode_ref("float32", 0), **_tol("float32"))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(_segment_split("float32", 3, 0, ns)),
                                   _segment_ref("float32", 3, 0), **_tol("float32"))
