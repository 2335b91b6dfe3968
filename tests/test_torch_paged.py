"""The port's paged KV cache against the JAX package's, on the CPU.

- The plain versions of the paged kernels against the Pallas kernels in
  interpret mode (the JAX package's own CPU route, patched in by a fixture;
  nothing in ultravox_tpu changes): ``paged_decode_attention`` and
  ``paged_segment_tail_attention`` to 1e-5 absolute in fp32 (summation order
  only), ``gather_pages`` bit-equal.
- ``decoder_forward`` with a PagedKVCache against the port's contiguous
  cache: logits to 2e-5 absolute plus 1e-5 relative (the JAX paged tests'
  own tolerance); against JAX's paged path (fp32, JAX at ``highest`` matmul
  precision): 1e-4 relative plus 2e-4 of the largest logit, since the test
  weights are scaled up 8x and summation-order noise grows with them (the
  port's contiguous path differs from JAX's by as much).
- The paged ``segmented_decode_scan(attn_impl="kernel")``: greedy tokens
  equal to JAX's, tail k/v to 1e-4 of their largest value.
- ``sample_slots``: greedy rows exactly JAX's argmax; the -inf mask of
  ``scale_and_filter_logits`` equal to JAX's, finite values to 1e-6.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import make_configs, make_params
from ultravox_torch.models import decoder as tdec
from ultravox_torch.ops import sampling as tsamp
from ultravox_torch.ops.kernels import paged_attention as tpa
from ultravox_torch.ops.kernels import paged_gather as tpg
from ultravox_torch.ops.kernels import segment_attention as tsa
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.ops import sampling as jsamp
from ultravox_tpu.ops.pallas import paged_attention as jpa
from ultravox_tpu.ops.pallas import paged_gather as jpg
from ultravox_tpu.ops.pallas import segment_attention as jsa

KERNEL_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-5, atol=2e-5)


def assert_close_to_jax(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=2e-4 * np.abs(ref).max())


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's paged kernels in interpret mode, where its decoder
    imports them (at trace time)."""
    monkeypatch.setattr(
        jpa, "paged_decode_attention", functools.partial(jpa.paged_decode_attention, interpret=True)
    )
    monkeypatch.setattr(
        jsa, "paged_segment_tail_attention",
        functools.partial(jsa.paged_segment_tail_attention, interpret=True),
    )


def _table(B, n_per, P, used, rng):
    """Sentinel-padded (B, n_per) tables with ``used[b]`` pages per row drawn
    from a shuffled pool (no page shared between rows)."""
    order = iter(rng.permutation(P))
    table = np.full((B, n_per), P, np.int32)
    for b in range(B):
        for i in range(used[b]):
            table[b, i] = next(order)
    return table


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# kernels' plain versions against Pallas
# --------------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("window", [0, 3])
def test_paged_decode_attention_matches_pallas(page_size, window):
    """GQA group 4, shuffled page ids, sentinel entries past each row's
    pages, and a pageless row of length 1 (every entry the sentinel)."""
    rng = np.random.default_rng(0)
    B, H, Hkv, D, n_per, P = 4, 8, 2, 64, 5, 14
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, page_size, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page_size, Hkv, D)).astype(np.float32)
    lens = np.array([1, 2 * page_size + 3, 5 * page_size, 1], np.int32)
    used = [1, 3, 5, 0]  # row 3 owns no page
    table = _table(B, n_per, P, used, rng)
    ref = jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)), window, interpret=True
    )
    before = tpa.paged_decode_attention.launches
    out = tpa.paged_decode_attention(*(_t(a) for a in (q, kp, vp, table, lens)), window)
    assert tpa.paged_decode_attention.launches == before  # a CPU tensor takes the plain version
    assert tuple(out.shape) == (B, H, D) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


def test_gather_pages_matches_pallas_bit_for_bit():
    rng = np.random.default_rng(1)
    L, P, ps, Hkv, D, B, n_per = 3, 9, 8, 2, 16, 3, 4
    kp = rng.standard_normal((L, P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, Hkv, D)).astype(np.float32)
    table = _table(B, n_per, P, [4, 2, 0], rng)  # sentinels in rows 1 and 2
    rk, rv = jpg.gather_pages(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table), interpret=True)
    before = tpg.gather_pages.launches
    ok, ov = tpg.gather_pages(_t(kp), _t(vp), _t(table))
    assert tpg.gather_pages.launches == before
    assert tuple(ok.shape) == (L, B, n_per * ps, Hkv, D)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))


@pytest.mark.parametrize("T", [1, 3])
def test_paged_segment_tail_attention_matches_pallas(T):
    """T queries at layer 2 of a 3-layer pool (page size 8) plus a tail,
    window 6, ragged prompt lengths and tail fill."""
    rng = np.random.default_rng(2)
    L, P, ps, Hkv, G, D, B, n_per, Ts = 3, 12, 8, 2, 2, 64, 3, 4, 8
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    kp = rng.standard_normal((L, P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((L, P, ps, Hkv, D)).astype(np.float32)
    tk = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    tv = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    lens = np.array([5, 17, 32], np.int32)
    written = np.array([0, 3, Ts - T], np.int32)
    table = _table(B, n_per, P, [1, 3, 4], rng)
    for window in (0, 6):
        ref = jsa.paged_segment_tail_attention(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(2, jnp.int32),
            jnp.asarray(table), jnp.asarray(lens), jnp.asarray(tk), jnp.asarray(tv),
            jnp.asarray(written), window, interpret=True,
        )
        before = tsa.paged_segment_tail_attention.launches
        out = tsa.paged_segment_tail_attention(
            _t(q), _t(kp), _t(vp), 2, _t(table), _t(lens), _t(tk), _t(tv), _t(written), window
        )
        assert tsa.paged_segment_tail_attention.launches == before
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **KERNEL_TOL)


# --------------------------------------------------------------------------
# paged decoder against JAX
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    return jcfg.text_config, tcfg.text_config, jparams["language_model"], tparams["language_model"]


def _jax_forward(cfg, **static):
    return jax.jit(functools.partial(jdec.decoder_forward, cfg=cfg, **static),
                   static_argnames=("return_hidden",))


def _pool_k(pool) -> np.ndarray:
    """The port pool's (L, P, ...) pages, without its write-only page."""
    return pool.pool()[0].numpy()


@pytest.mark.parametrize("window", [None, 8])
def test_paged_decoder_matches_jax_and_contiguous(llama, window):
    """Prefill into a shuffled pool (page size 8) and three greedy decode
    steps: logits equal JAX's paged path and the port's contiguous path at
    every step, and the pool's pages equal JAX's. ``window`` makes every
    layer mistral-local."""
    jd, td, jp, tp = llama
    jd = dataclasses.replace(jd, sliding_window=window)
    td = dataclasses.replace(td, sliding_window=window)
    B, T, ps, S = 2, 24, 8, 40
    rng = np.random.default_rng(3)
    ids = rng.integers(1, td.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    table = _table(B, S // ps, 16, [-(-24 // ps) + 1, -(-17 // ps) + 1], rng)
    jpool = jdec.PagedKVCache.zeros(jd, 16, ps, jnp.float32)
    tpool = tdec.PagedKVCache.zeros(td, 16, ps, torch.float32)
    tcache = tdec.KVCache.zeros(td, B, S, torch.float32)
    kw = dict(positions=pos, kv_valid_len=lens, write_pos=np.zeros((B,), np.int32))
    jl, jpool = _jax_forward(jd)(jp, input_ids=jnp.asarray(ids), cache=jpool,
                                 page_table=jnp.asarray(table),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    tkw = {k: _t(v) for k, v in kw.items()}
    tl, _ = tdec.decoder_forward(tp, td, input_ids=_t(ids), cache=tpool, page_table=_t(table), **tkw)
    cl, _ = tdec.decoder_forward(tp, td, input_ids=_t(ids), cache=tcache, **tkw)
    assert_close_to_jax(tl, jl)
    np.testing.assert_allclose(tl.numpy(), cl.numpy(), **LOGIT_TOL)
    tok = jnp.argmax(jl[jnp.arange(B), jnp.asarray(lens) - 1], -1).astype(jnp.int32)
    tok = np.asarray(tok)
    for _ in range(3):
        skw = dict(positions=lens[:, None], kv_valid_len=lens + 1, write_pos=lens)
        jl, jpool = _jax_forward(jd)(jp, input_ids=jnp.asarray(tok[:, None]), cache=jpool,
                                     page_table=jnp.asarray(table),
                                     **{k: jnp.asarray(v) for k, v in skw.items()})
        tskw = {k: _t(v) for k, v in skw.items()}
        tl, _ = tdec.decoder_forward(tp, td, input_ids=_t(tok[:, None]), cache=tpool,
                                     page_table=_t(table), **tskw)
        cl, _ = tdec.decoder_forward(tp, td, input_ids=_t(tok[:, None]), cache=tcache, **tskw)
        assert_close_to_jax(tl, jl)
        np.testing.assert_allclose(tl.numpy(), cl.numpy(), **LOGIT_TOL)
        tok = np.asarray(jl[:, 0].argmax(-1)).astype(np.int32)
        assert tok.tolist() == tl[:, 0].argmax(-1).tolist()
        lens = lens + 1
    jk = np.asarray(jpool.k)  # pool k/v reach ~50 with the x8 weights
    np.testing.assert_allclose(_pool_k(tpool), jk, rtol=1e-4, atol=1e-4 * np.abs(jk).max())


def test_paged_write_indices_match_jax():
    """Pages and offsets of in-range writes equal JAX's; every write JAX
    drops (past the table, sentinel entries, negative positions) goes to the
    port's write-only page num_pages."""
    table = np.array([[3, 0, 7], [5, 7, 7]], np.int32)  # 7 = sentinel (P = 7)
    pos = np.array([[0, 9, 17, 24, 30], [-1, 3, 8, 15, 40]], np.int32)
    jpage, joff = jdec.paged_positions_to_indices(jnp.asarray(table), jnp.asarray(pos), 8, 7)
    tpage, toff = tdec.paged_positions_to_indices(_t(table), _t(pos), 8, 7)
    jpage, joff = np.asarray(jpage), np.asarray(joff)
    kept = jpage < 7
    assert kept.sum() == 3
    np.testing.assert_array_equal(tpage.numpy()[kept], jpage[kept])
    np.testing.assert_array_equal(tpage.numpy()[~kept], 7)
    np.testing.assert_array_equal(toff.numpy(), joff)
    wp, _ = tdec.paged_write_indices(_t(table), torch.tensor([22, 0], dtype=torch.int32), 3, 8, 7)
    assert wp.tolist() == [[7, 7, 7], [5, 5, 5]]


def test_paged_inactive_write_is_dropped(llama):
    """A row whose write position is out of range (an inactive slot) leaves
    every pool page bit-identical; only the active row's page changes."""
    _, td, _, tp = llama
    pool = tdec.PagedKVCache.zeros(td, 8, 8, torch.float32)
    table = _t(_table(2, 3, 8, [1, 1], np.random.default_rng(4)))
    before = _pool_k(pool).copy()
    wp = torch.tensor([0, 3 * 8 + 100], dtype=torch.int32)
    tdec.decoder_forward(
        tp, td, input_ids=torch.tensor([[5], [9]]), positions=wp[:, None],
        kv_valid_len=torch.tensor([1, 1], dtype=torch.int32), cache=pool, page_table=table,
        write_pos=wp,
    )
    after = _pool_k(pool)
    changed = [p for p in range(8) if not np.array_equal(before[:, p], after[:, p])]
    assert changed == [int(table[0, 0])]


def test_paged_decode_kernel_matches_jax_and_gather_path(llama, pallas_interpret):
    """decode_kernel=True through a PagedKVCache (the plain version of
    paged_decode_attention here) against JAX's paged kernel path (Pallas in
    interpret mode) and the port's own gather path."""
    jd, td, jp, tp = llama
    B, T, ps = 2, 10, 8
    rng = np.random.default_rng(5)
    ids = rng.integers(1, td.vocab_size, (B, T)).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    table = _table(B, 4, 8, [3, 3], rng)
    jpool = jdec.PagedKVCache.zeros(jd, 8, ps, jnp.float32)
    tpool = tdec.PagedKVCache.zeros(td, 8, ps, torch.float32)
    kw = dict(positions=pos, kv_valid_len=np.full((B,), T, np.int32), write_pos=np.zeros((B,), np.int32))
    jl, jpool = _jax_forward(jd)(jp, input_ids=jnp.asarray(ids), cache=jpool,
                                 page_table=jnp.asarray(table),
                                 **{k: jnp.asarray(v) for k, v in kw.items()})
    tdec.decoder_forward(tp, td, input_ids=_t(ids), cache=tpool, page_table=_t(table),
                         **{k: _t(v) for k, v in kw.items()})
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)[:, None]
    skw = dict(positions=np.full((B, 1), T, np.int32), kv_valid_len=np.full((B,), T + 1, np.int32),
               write_pos=np.full((B,), T, np.int32))
    jk, _ = _jax_forward(jd, decode_kernel=True)(
        jp, input_ids=jnp.asarray(tok), cache=jpool, page_table=jnp.asarray(table),
        **{k: jnp.asarray(v) for k, v in skw.items()})
    outs = []
    for kernel in (True, False):
        pool = tdec.PagedKVCache(k=tpool.k.clone(), v=tpool.v.clone())
        outs.append(tdec.decoder_forward(
            tp, td, input_ids=_t(tok), cache=pool, page_table=_t(table), decode_kernel=kernel,
            **{k: _t(v) for k, v in skw.items()})[0])
    assert_close_to_jax(outs[0], jk)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **LOGIT_TOL)


def _greedy(logits):
    return logits.argmax(-1).to(torch.int32)


def test_paged_segmented_scan_matches_jax(llama, pallas_interpret):
    """The kernel scan over a paged pool: greedy tokens and the returned tail
    against JAX's paged kernel scan (Pallas in interpret mode); a page table
    with attn_impl="xla" raises ValueError, as in JAX."""
    jd, td, jp, tp = llama
    B, T, ps = 2, 12, 8
    rng = np.random.default_rng(6)
    ids = rng.integers(1, td.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([T, T - 3], np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    table = _table(B, 4, 10, [2, 2], rng)
    jpool = jdec.PagedKVCache.zeros(jd, 10, ps, jnp.float32)
    tpool = tdec.PagedKVCache.zeros(td, 10, ps, torch.float32)
    kw = dict(positions=pos, kv_valid_len=lens, write_pos=np.zeros((B,), np.int32))
    _, jpool = _jax_forward(jd, return_hidden=True)(
        jp, input_ids=jnp.asarray(ids), cache=jpool, page_table=jnp.asarray(table),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tdec.decoder_forward(tp, td, input_ids=_t(ids), cache=tpool, page_table=_t(table),
                         return_hidden=True, **{k: _t(v) for k, v in kw.items()})
    first = np.array([11, 200], np.int32)
    jt, jtail = jdec.segmented_decode_scan(
        jp, jd, jpool, jnp.asarray(lens), jnp.asarray(first), jax.random.key(0), n_steps=8,
        sample_fn=lambda lg, key: jnp.argmax(lg, -1).astype(jnp.int32), return_tail=True,
        attn_impl="kernel", page_table=jnp.asarray(table),
    )
    tt, ttail = tdec.segmented_decode_scan(
        tp, td, tpool, _t(lens), _t(first), n_steps=8, sample_fn=_greedy, return_tail=True,
        attn_impl="kernel", page_table=_t(table),
    )
    assert tt.tolist() == np.asarray(jt).tolist()
    assert len(set(tt[0].tolist())) > 3, "degenerate tokens prove little"
    for t, j in ((ttail.k, jtail.k), (ttail.v, jtail.v)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    with pytest.raises(ValueError, match="attn_impl='kernel'"):
        tdec.segmented_decode_scan(tp, td, tpool, _t(lens), _t(first), n_steps=2,
                                   sample_fn=_greedy, page_table=_t(table))


# --------------------------------------------------------------------------
# per-slot sampling
# --------------------------------------------------------------------------


def test_sample_slots_matches_jax():
    """Mixed rows: greedy, plain temperature, top-k, top-p, min-p. Greedy
    rows equal JAX's argmax exactly; the filter's -inf mask equals JAX's and
    its finite values agree to 1e-6; sampled rows draw inside the mask."""
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((5, 300))).astype(np.float32)
    samp = np.array([[0.0, 0, 1.0, 0.0], [0.9, 0, 1.0, 0.0], [0.7, 20, 1.0, 0.0],
                     [1.1, 0, 0.8, 0.0], [0.8, 0, 1.0, 0.05]], np.float32)
    ref = np.asarray(jsamp.scale_and_filter_logits(jnp.asarray(logits), jnp.asarray(samp)))
    sampled, filtered = tsamp.sampling_flags(samp)
    assert sampled and filtered
    out = tsamp.scale_and_filter_logits(_t(logits), _t(samp), filtered=True).numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-6, atol=1e-6)
    assert 0 < np.isneginf(ref[2:]).sum(-1).min()  # every filter removed something
    plain = tsamp.scale_and_filter_logits(_t(logits[:2]), _t(samp[:2]), filtered=False).numpy()
    np.testing.assert_allclose(plain, ref[:2], rtol=1e-6, atol=1e-6)

    jtok = np.asarray(jsamp.sample_slots(jnp.asarray(logits), jnp.asarray(samp), jax.random.key(0)))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsamp.sample_slots(_t(logits), _t(samp), gen, sampled=True, filtered=True).numpy()
        assert tok[0] == jtok[0] == logits[0].argmax()
        assert all(np.isfinite(ref[r, tok[r]]) for r in range(1, 5))
    greedy = tsamp.sample_slots(_t(logits), _t(samp), gen, sampled=False, filtered=False)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))
