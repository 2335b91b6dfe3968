"""The split KV kernel's arithmetic through a page table, emulated on the CPU,
against the TPU's paged kernels.

On the card ``paged_decode_attention`` (#9) and
``paged_segment_tail_attention`` (#12) run the paged instances of
``ultravox_torch/ops/kernels/csrc/kv_split.cuh``: each row's visible keys
(pool pages through the row's table, then the tail) split across a cluster
of NS blocks whose partial softmax states (m, z, acc) merge in rank order.
The plain versions with ``softmax=split_softmax_plain`` emulate that split
and merge on the clamped page gather; here they are held against the Pallas
kernels in interpret mode (the JAX package's own CPU route; nothing in
ultravox_tpu changes) at NS 1, 2, 5 and 8, with shuffled tables, sentinel
entries, a pageless row of length 1, pages of 16 and of 48 (not a power of
two), windows 0 and 21 (which start mid-page), T 1 and 3, and splits that
fall inside the tail.

Tolerances, those of test_torch_kv_split.py: fp32 2e-5 absolute (summation
order only); bf16 2^-6 relative plus 2^-6 absolute. A merge that drops the
exp(m_i - m) rescale must fail the same comparison.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ultravox_torch.ops.kernels import decode_attention as tda
from ultravox_torch.ops.kernels import paged_attention as tpa
from ultravox_torch.ops.kernels import segment_attention as tsa
from ultravox_tpu.ops.pallas import paged_attention as jpa
from ultravox_tpu.ops.pallas import segment_attention as jsa

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SPLITS = [1, 2, 5, 8]
PAGE_SIZES = [16, 48]
S = 192  # slots a row's table spans: 12 pages of 16, 4 of 48

# decode: GQA 4; row 0 is the pageless inactive slot (length 1, every entry
# the sentinel), row 1 (5 keys) leaves every rank but 0 empty, rows 2 and 3
# end mid-page and span several ranks at NS 8
DEC = dict(B=4, H=8, Hkv=2, D=64, lens=[1, 5, 100, 190])
# segment: layer 1 of a 2-layer pool plus a 24-slot tail; at NS 2 and T = 1,
# row 1's 30 keys (9 pool keys, tail slots 0-20) split at tail slot 7
SEG = dict(L=2, B=4, Hkv=2, G=2, D=64, Ts=24, lens=[1, 9, 40, 90], written=[5, 20, 3, 20])
WINDOWS = [0, 21]  # 21 keys back from 100 or 90 starts inside a page of 16 and of 48


def _tol(dt):
    return dict(rtol=0, atol=2e-5) if dt == "float32" else dict(rtol=2**-6, atol=2**-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _table(lens, ps, rng):
    """(B, S / ps) int32: ceil(n / ps) pages per row at shuffled ids (none
    for a row of length 1), the sentinel P after them; P leaves 2 spare
    pages. Returns (table, P)."""
    used = [-(-n // ps) if n > 1 else 0 for n in lens]
    P = sum(used) + 2
    order = iter(rng.permutation(P))
    table = np.full((len(lens), S // ps), P, np.int32)
    for b, u in enumerate(used):
        for i in range(u):
            table[b, i] = next(order)
    return table, P


@functools.lru_cache(maxsize=None)
def _decode_inputs(ps):
    rng = np.random.default_rng(21 + ps)
    B, H, Hkv, D = (DEC[k] for k in ("B", "H", "Hkv", "D"))
    table, P = _table(DEC["lens"], ps, rng)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return r(B, H, D), r(P, ps, Hkv, D), r(P, ps, Hkv, D), table, np.array(DEC["lens"], np.int32)


@functools.lru_cache(maxsize=None)
def _decode_ref(dt, ps, window):
    """The Pallas paged decode kernel in interpret mode, as numpy fp32."""
    q, kp, vp, table, lens = _decode_inputs(ps)
    jdt = DTYPES[dt][1]
    out = jpa.paged_decode_attention(*(jnp.asarray(a).astype(jdt) for a in (q, kp, vp)),
                                     jnp.asarray(table), jnp.asarray(lens), window, interpret=True)
    return _np(out)


def _decode_split(dt, ps, window, ns):
    tdt = DTYPES[dt][0]
    q, kp, vp, table, lens = _decode_inputs(ps)
    return tpa.paged_decode_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, kp, vp)), torch.from_numpy(table),
        torch.from_numpy(lens), window, scale=DEC["D"] ** -0.5,
        softmax=functools.partial(tda.split_softmax_plain, ns=ns))


@functools.lru_cache(maxsize=None)
def _segment_inputs(T, ps):
    rng = np.random.default_rng(31 + T + ps)
    L, B, Hkv, G, D, Ts = (SEG[k] for k in ("L", "B", "Hkv", "G", "D", "Ts"))
    table, P = _table(SEG["lens"], ps, rng)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    written = np.minimum(np.array(SEG["written"], np.int32), Ts - T)
    return (r(B, T, Hkv * G, D), r(L, P, ps, Hkv, D), r(L, P, ps, Hkv, D), table,
            np.array(SEG["lens"], np.int32), r(B, Ts, Hkv, D), r(B, Ts, Hkv, D), written)


@functools.lru_cache(maxsize=None)
def _segment_ref(dt, T, ps, window):
    q, kp, vp, table, lens, tk, tv, written = _segment_inputs(T, ps)
    jdt = DTYPES[dt][1]
    f = lambda a: jnp.asarray(a).astype(jdt)  # noqa: E731
    out = jsa.paged_segment_tail_attention(
        f(q), f(kp), f(vp), jnp.asarray(1, jnp.int32), jnp.asarray(table), jnp.asarray(lens),
        f(tk), f(tv), jnp.asarray(written), window, interpret=True)
    return _np(out)


def _segment_split(dt, T, ps, window, ns):
    tdt = DTYPES[dt][0]
    q, kp, vp, table, lens, tk, tv, written = _segment_inputs(T, ps)
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    return tsa.paged_segment_tail_attention_plain(
        t(q), t(kp), t(vp), 1, torch.from_numpy(table), torch.from_numpy(lens), t(tk), t(tv),
        torch.from_numpy(written), window, scale=SEG["D"] ** -0.5,
        softmax=functools.partial(tda.split_softmax_plain, ns=ns))


@pytest.mark.parametrize("ns", SPLITS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_decode_split_matches_pallas(dt, ps, window, ns):
    """Shuffled pages with sentinel entries, the pageless row, rows ending
    mid-page; GQA 4."""
    out = _decode_split(dt, ps, window, ns)
    assert out.dtype == DTYPES[dt][0] and tuple(out.shape) == (DEC["B"], DEC["H"], DEC["D"])
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(_np(out), _decode_ref(dt, ps, window), **_tol(dt))


@pytest.mark.parametrize("ns", SPLITS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_paged_segment_split_matches_pallas(dt, T, window, ns):
    """T queries against layer 1's pages plus the tail, in pages of 16 and
    of 48; prompt lengths 1 (pageless) to 90, 3-21 tail slots written
    before."""
    for ps in PAGE_SIZES:
        out = _segment_split(dt, T, ps, window, ns)
        assert torch.isfinite(out).all()
        np.testing.assert_allclose(_np(out), _segment_ref(dt, T, ps, window), **_tol(dt))


@pytest.mark.parametrize("ps", PAGE_SIZES)
def test_paged_split_layout_crosses_pages_and_the_tail(ps):
    """The cases above exercise what they claim: the pageless row reads one
    key of the clamped sentinel page (P - 1), rank shares end inside pages
    (the page lookup restarts mid-page), a window starts mid-page, and at NS
    2 row 1's split falls inside the tail."""
    _, _, _, table, lens = _decode_inputs(ps)
    P = int(table.max())
    assert (table[0] == P).all() and lens[0] == 1  # pageless: its key 0 reads page P - 1
    assert np.minimum(table[0, 0], P - 1) == P - 1
    n, pos = torch.from_numpy(lens).long()[:, None], torch.arange(S)[None]
    (dec,) = [r.numpy() for r in tda.key_ranks([((pos < n) & (pos >= n - 21))[:, None, None]], 8)]
    keys = np.nonzero(dec[2] >= 0)[0]  # row 2, window 21: keys 79-99
    assert keys[0] % ps  # the window starts inside a page
    starts = [k for k in keys[1:] if dec[2][k] != dec[2][k - 1]]  # first key of each later rank
    assert starts and all(k % ps for k in starts)  # rank 1 starts inside a page
    assert (SEG["lens"][3] + SEG["written"][3] - 21 + 1) % ps  # as the segment's window

    # segment, T = 1, no window: row 1's 9 pool keys then tail slots 0-20
    Ts = SEG["Ts"]
    seg_lens, written = torch.tensor(SEG["lens"]), torch.tensor(SEG["written"])
    ok_p = (torch.arange(S)[None] < seg_lens[:, None])[:, None, None, None]
    ok_t = (torch.arange(Ts)[None] <= written[:, None])[:, None, None, None]
    pool, tail = [r.numpy() for r in tda.key_ranks([ok_p, ok_t], 2)]
    assert set(pool[1][pool[1] >= 0]) == {0}
    assert list(tail[1][:21]) == [0] * 7 + [1] * 14


def _merge_without_rescale(parts, q_dtype):
    """A planted fault: the partial sums added without exp(m_i - m)."""
    z = sum(zi for _, zi, _ in parts)
    acc = sum(ai for _, _, ai in parts)
    return (acc / torch.clamp(z, min=1e-30)).to(q_dtype)


@pytest.mark.parametrize("ns", [2, 5, 8])
def test_a_paged_merge_without_the_rescale_fails(monkeypatch, ns):
    """The comparisons above catch a merge that skips the rescale, in fp32,
    for the decode and the segment case through a table of 48-token pages."""
    monkeypatch.setattr(tda, "merge_partials_plain", _merge_without_rescale)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(_decode_split("float32", 48, 0, ns)),
                                   _decode_ref("float32", 48, 0), **_tol("float32"))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(_segment_split("float32", 3, 48, 0, ns)),
                                   _segment_ref("float32", 3, 48, 0), **_tol("float32"))
