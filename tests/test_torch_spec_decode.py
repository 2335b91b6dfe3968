"""Prompt-lookup speculative decoding in the port, on the CPU, against the
JAX package (mirrors tests/test_spec_decode.py at a small size).

``_ngram_drafts`` and greedy ``spec_accept_slots`` are equal to JAX's on the
same arrays (exact); sampled rows hold the accept / reject rule by
distribution (total variation within 0.02 of the exact distribution over
40000 draws). ``segmented_spec_scan`` against JAX's with both attention
forms and paged (the kernels' plain versions), with a sliding-window model
too: emitted tokens, accept counts, lengths and histories exact, the tail
k/v within 1e-4 (fp32). The engine in slots and paged modes, single rounds
and multi-round blocks: greedy tokens equal to the non-speculative engine,
the JAX GenerationEngine and the JAX speculative engine (exact), and the
cases of the JAX tests: disengagement for penalties / logprobs / seeded
sampling, churn and stop tokens, multi-LoRA, the cache edge, and the
health guard's pause and re-probe.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import make_configs
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import decoder as tdec
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import sampling as tsamp
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.ops import sampling as jsamp

MAX_NEW = 24
# the LM at 2x its init scale: greedy outputs run in repeats with changes,
# so drafts are accepted in part (all-miss and all-hit rounds both occur)
LM_SCALE = 2.0


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs()
    jp = juv.init_params(jcfg, jax.random.key(0))
    jp = {k: jax.tree.map(lambda a: a * LM_SCALE if a.ndim >= 2 else a, v)
          for k, v in jp.items()}
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(0)
    batches = []
    for n, period in ((20, 6), (33, 5), (9, 3)):
        pat = rng.integers(1, 512, period)
        ids = np.tile(pat, 12)[:n][None].astype(np.int32)
        batches.append({"input_ids": ids, "attention_mask": np.ones_like(ids)})
    jeng = JEngine(jp, jcfg, max_cache_len=160, cache_dtype=jnp.float32)
    expected = [jeng.generate(b, max_new_tokens=MAX_NEW).token_ids[0] for b in batches]
    # runs of one token with changes between them (drafts hit inside a run
    # and miss at a change) and one row that never changes (every draft hits)
    assert sum(len(set(e)) for e in expected) >= 8, "degenerate tokens prove little"
    return jcfg, tcfg, jp, tp, batches, expected, jeng


def _engine(tp, tcfg, **kw):
    base = dict(num_slots=4, max_seq_len=128, cache_dtype=torch.float32, device="cpu",
                prefill_len_buckets=(64, 128), mel_len_buckets=(400,), prefill_chunk_tokens=16,
                page_size=16, spec_decode="ngram", spec_k=4)
    base.update(kw)
    if base.get("cache_mode", "slots") == "slots":
        base["cache_mode"] = "slots"
        base.pop("page_size")
    return tserve.ServingEngine(tp, tcfg, **base)


def _drain(engine, req):
    ids, finish = [], None
    for ev in engine.stream(req, timeout=120):
        if ev.token_id is None:
            finish = ev.finish_reason
            break
        ids.append(ev.token_id)
    return ids, finish


def _serve(engine, batches, **kw):
    engine.start()
    try:
        reqs = [engine.submit(dict(b), **kw) for b in batches]
        return [_drain(engine, r) for r in reqs]
    finally:
        engine.stop()


# -- the functions ------------------------------------------------------------


def test_ngram_drafts_match_jax():
    """The JAX test's hand-made rows, then random histories with repeats, at
    ngram 2 and 3: drafts equal to JAX's."""
    S, K = 32, 4
    hist = np.zeros((4, S), np.int32)
    hist[0, :6] = [5, 6, 7, 8, 5, 6]
    hist[1, :8] = [1, 2, 9, 1, 2, 3, 1, 2]
    hist[2, :4] = [10, 11, 12, 13]
    hist[3, :5] = [7, 3, 9, 4, 3]
    hl = np.array([6, 8, 4, 5], np.int32)
    got = tserve._ngram_drafts(torch.from_numpy(hist), torch.from_numpy(hl), K, 2).numpy()
    want = np.asarray(jserve._ngram_drafts(jnp.asarray(hist), jnp.asarray(hl), K, 2))
    assert got.tolist() == want.tolist()
    assert got[0].tolist() == [7, 8, 5, 6] and got[3].tolist() == [9, 4, 3, 0]
    rng = np.random.default_rng(1)
    for ngram in (2, 3):
        hist = rng.integers(0, 6, (8, 48)).astype(np.int32)
        hl = rng.integers(1, 48, 8).astype(np.int32)
        got = tserve._ngram_drafts(torch.from_numpy(hist), torch.from_numpy(hl), 5, ngram)
        want = jserve._ngram_drafts(jnp.asarray(hist), jnp.asarray(hl), 5, ngram)
        assert got.dtype == torch.int32
        assert got.numpy().tolist() == np.asarray(want).tolist()


def test_spec_accept_greedy_matches_jax():
    """Greedy rows: drafts that agree with the argmax for a random leading
    run, then differ; out and accepted equal to JAX's."""
    rng = np.random.default_rng(2)
    B, K, V = 16, 4, 64
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    arg = logits.argmax(-1)
    drafts = arg[:, :K].copy()
    for b in range(B):
        cut = rng.integers(0, K + 1)
        if cut < K:
            drafts[b, cut] = (drafts[b, cut] + 1 + rng.integers(0, V - 1)) % V
    samp = np.tile(np.array([[0.0, 0, 1.0, 0]], np.float32), (B, 1))
    out, acc = tsamp.spec_accept_slots(
        torch.from_numpy(logits), torch.from_numpy(drafts.astype(np.int32)),
        torch.from_numpy(samp), None, sampled=False, filtered=False)
    jout, jacc = jsamp.spec_accept_slots(jnp.asarray(logits), jnp.asarray(drafts, jnp.int32),
                                         jnp.asarray(samp), jax.random.key(0))
    assert acc.numpy().tolist() == np.asarray(jacc).tolist()
    assert out.numpy().tolist() == np.asarray(jout).tolist()
    assert set(acc.tolist()) > {1, K + 1}  # every run length occurs


@pytest.mark.parametrize("seeded", [False, True])
def test_spec_accept_sampled_distribution(seeded):
    """Sampled rows: the first emitted token is distributed as p0 (total
    variation < 0.02 over 40000 rows), the draft is accepted with
    probability p0[draft], a rejection never emits the draft and follows
    the residual; when every draft is accepted the bonus token follows p_K.
    Seeded rows (one seed a row) give the same law and repeat their draws
    whatever the generator."""
    Vs, K, N = 8, 2, 40_000
    rng0 = np.random.default_rng(3)
    rows = rng0.standard_normal((K + 1, Vs)).astype(np.float32)
    p = torch.softmax(torch.from_numpy(rows), -1).numpy()
    draft0 = int(np.argmax(p[0]))
    draft1 = int(np.argmax(p[1]))
    logits = torch.from_numpy(rows)[None].expand(N, K + 1, Vs)
    drafts = torch.tensor([[draft0, draft1]], dtype=torch.int32).expand(N, K)
    samp = torch.tensor([[1.0, 0, 1.0, 0]]).expand(N, 4)
    kw = {}
    if seeded:
        kw = dict(seeds=torch.arange(N, dtype=torch.int32), positions=torch.full((N,), 7))
    gen = torch.Generator().manual_seed(0)
    out, acc = tsamp.spec_accept_slots(logits, drafts, samp, gen, sampled=True, filtered=False, **kw)
    firsts = out[:, 0].numpy()
    tv = 0.5 * np.abs(np.bincount(firsts, minlength=Vs) / N - p[0]).sum()
    assert tv < 0.02, tv
    assert abs((firsts == draft0).mean() - p[0][draft0]) < 0.02
    rej = firsts[firsts != draft0]
    residual = p[0].copy()
    residual[draft0] = 0
    residual /= residual.sum()
    assert 0.5 * np.abs(np.bincount(rej, minlength=Vs) / len(rej) - residual).sum() < 0.03
    assert (acc.numpy()[firsts != draft0] == 1).all()
    full = acc.numpy() == K + 1
    bonus = out[:, K].numpy()[full]
    assert 0.5 * np.abs(np.bincount(bonus, minlength=Vs) / len(bonus) - p[K]).sum() < 0.05
    if seeded:
        again = tsamp.spec_accept_slots(logits, drafts, samp, torch.Generator().manual_seed(99),
                                        sampled=True, filtered=False, **kw)
        assert torch.equal(again[0], out) and torch.equal(again[1], acc)


def test_spec_accept_filters_and_greedy_rows_together():
    """top-k 1 makes a sampled row greedy in law; a greedy row beside sampled
    rows still takes exact argmax acceptance."""
    rng = np.random.default_rng(4)
    B, K, V = 6, 3, 32
    logits = torch.from_numpy(rng.standard_normal((B, K + 1, V)).astype(np.float32))
    arg = logits.argmax(-1).to(torch.int32)
    drafts = arg[:, :K].clone()
    drafts[:, 1] = (drafts[:, 1] + 1) % V
    samp = torch.tensor([[0.0, 0, 1, 0], [0.7, 1, 1, 0], [0.7, 0, 1, 0]] * 2)
    out, acc = tsamp.spec_accept_slots(logits, drafts, samp, torch.Generator().manual_seed(0),
                                       sampled=True, filtered=True)
    for b in (0, 1, 3, 4):
        assert acc[b] == 2 and out[b, :2].tolist() == arg[b, :2].tolist()


def _scan_inputs(cfg, rng, B, S, lens, hist_len):
    L, Hkv, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    k = (rng.standard_normal((L, B, S, Hkv, Dh)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, B, S, Hkv, Dh)) * 0.5).astype(np.float32)
    hist = np.zeros((B, S + 8), np.int32)
    for b in range(B):
        pat = rng.integers(0, cfg.vocab_size, 3)
        hist[b, : hist_len[b]] = np.tile(pat, S)[: hist_len[b]]
    first = np.array([hist[b, hist_len[b] - 1] for b in range(B)], np.int32)
    return k, v, hist, first


def _forced_accept(round_counter, T):
    """An accept rule independent of the model: row b keeps
    (round + b) % T + 1 tokens, the argmax at each position."""

    def accept(argmax):
        B = argmax.shape[0]
        r = round_counter[0]
        round_counter[0] += 1
        return (np.arange(B) + r) % T + 1

    return accept


@pytest.mark.parametrize("accept", ["greedy", "forced"])
@pytest.mark.parametrize("form", ["xla", "kernel", "paged"])
@pytest.mark.parametrize("window", [False, True])
def test_segmented_spec_scan_matches_jax(form, accept, window):
    """Three rounds of K = 3 against JAX's scan (attn_impl="xla") on a random
    prompt cache of ragged lengths: the real greedy rule, and a forced rule
    that keeps 1..K+1 tokens by row and round so every tail offset is
    exercised. Paged: the same cache through shuffled pages of 8."""
    from ultravox_torch.models import config as tc
    from ultravox_tpu.models import config as jc

    fam = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_layers=2, num_heads=4,
               num_kv_heads=2, head_dim=16, rope_theta=10000.0)
    if window:
        fam.update(sliding_window=6, sliding_window_pattern=2)
    jcfg, tcfg = jc.DecoderConfig(**fam), tc.DecoderConfig(**fam)
    jp = jdec.init_params(jcfg, jax.random.key(5))
    jp = jax.tree.map(lambda a: a * 4 if a.ndim >= 2 else a, jp)
    tp = from_jax_params({"language_model": jax.tree.map(np.asarray, jp)},
                         tc.UltravoxConfig(text_config=tcfg, llm_only_training=True))["language_model"]
    rng = np.random.default_rng(6)
    B, S, K, R = 3, 40, 3, 3
    T = K + 1
    lens = np.array([5, 17, 11], np.int32)
    k, v, hist, first = _scan_inputs(jcfg, rng, B, S, lens, lens + 1)

    def run_jax():
        counter = [0]
        forced = _forced_accept(counter, T)

        def accept_fn(logits, drafts, key, hl):
            if accept == "greedy":
                samp = jnp.tile(jnp.asarray([[0.0, 0, 1.0, 0]]), (B, 1))
                return jsamp.spec_accept_slots(logits, drafts, samp, key)
            arg = jnp.argmax(logits, -1).astype(jnp.int32)
            return arg, jax.pure_callback(
                lambda a: forced(np.asarray(a)).astype(np.int32),
                jax.ShapeDtypeStruct((B,), jnp.int32), arg)

        return jdec.segmented_spec_scan(
            jp, jcfg, jdec.KVCache(k=jnp.asarray(k), v=jnp.asarray(v)), jnp.asarray(lens),
            jnp.asarray(first), jnp.asarray(hist),
            lambda h, hl: jserve._ngram_drafts(h, hl, K, 2), accept_fn, jax.random.key(0),
            n_rounds=R, K=K)

    jouts, jaccs, jtail, jwritten, jlast, jhist = run_jax()
    counter = [0]
    forced = _forced_accept(counter, T)

    def accept_fn(logits, drafts, hl):
        if accept == "greedy":
            samp = torch.tensor([[0.0, 0, 1.0, 0]]).expand(B, 4)
            return tsamp.spec_accept_slots(logits, drafts, samp, None, sampled=False,
                                           filtered=False)
        arg = logits.argmax(-1).to(torch.int32)
        return arg, torch.from_numpy(forced(arg.numpy()).astype(np.int32))

    kw = {}
    if form == "paged":
        ps = 8
        n_per = S // ps
        perm = rng.permutation(B * n_per)
        table = perm.reshape(B, n_per).astype(np.int32)
        pool = tdec.PagedKVCache.zeros(tcfg, B * n_per, ps, torch.float32)
        for b in range(B):
            for i in range(n_per):
                pool.k[:, table[b, i]] = torch.from_numpy(k[:, b, i * ps:(i + 1) * ps])
                pool.v[:, table[b, i]] = torch.from_numpy(v[:, b, i * ps:(i + 1) * ps])
        cache = pool
        kw["page_table"] = torch.from_numpy(table)
    else:
        cache = tdec.KVCache(k=torch.from_numpy(k), v=torch.from_numpy(v))
    thist = torch.from_numpy(hist.copy())
    outs, accs, tail, written, last, hist_out = tdec.segmented_spec_scan(
        tp, tcfg, cache, torch.from_numpy(lens), torch.from_numpy(first), thist,
        lambda h, hl: tserve._ngram_drafts(h, hl, K, 2), accept_fn, n_rounds=R, K=K,
        attn_impl="xla" if form == "xla" else "kernel", **kw)
    assert hist_out is thist
    assert accs.numpy().tolist() == np.asarray(jaccs).tolist()
    assert outs.numpy().tolist() == np.asarray(jouts).tolist()
    assert written.numpy().tolist() == np.asarray(jwritten).tolist()
    assert last.numpy().tolist() == np.asarray(jlast).tolist()
    assert thist.numpy().tolist() == np.asarray(jhist).tolist()
    for b in range(B):
        n = int(written[b])
        np.testing.assert_allclose(tail.k[:, b, :n].numpy(), np.asarray(jtail.k)[:, b, :n],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tail.v[:, b, :n].numpy(), np.asarray(jtail.v)[:, b, :n],
                                   atol=1e-4, rtol=1e-4)
    if accept == "forced":
        assert sorted(set(accs.flatten().tolist())) == list(range(1, T + 1))


def test_segmented_spec_scan_paged_needs_kernel(setup):
    _, tcfg, _, tp, _, _, _ = setup
    tc = tcfg.text_config
    pool = tdec.PagedKVCache.zeros(tc, 4, 16, torch.float32)
    with pytest.raises(ValueError, match="attn_impl='kernel'"):
        tdec.segmented_spec_scan(
            tp["language_model"], tc, pool, torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.zeros((1, 64), dtype=torch.int32),
            None, None, n_rounds=1, K=2, page_table=torch.zeros((1, 4), dtype=torch.int32))


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("block_impl", ["xla", "kernel"])
@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_spec_engine_matches_jax_generate(setup, mode, rounds, block_impl):
    """Greedy tokens equal to the JAX GenerationEngine's, speculation
    engaged and accepting more than one token a round on average; with 4
    rounds the block buckets are [4, 2] and multi-round dispatches run."""
    _, tcfg, _, tp, batches, expected, _ = setup
    eng = _engine(tp, tcfg, cache_mode=mode, decode_block_steps=rounds, block_attn_impl=block_impl,
                  decode_attn_impl="kernel" if block_impl == "kernel" else "xla",
                  spec_min_accept=0)
    if rounds == 4:
        assert eng.spec_rounds == 4 and eng._spec_round_buckets == [4, 2]
    got = _serve(eng, batches, max_tokens=MAX_NEW)
    assert got == [(e, "length") for e in expected]
    assert eng.spec_dispatches > 0
    assert eng.spec_emitted_tokens > eng.spec_dispatches
    assert 1.0 <= eng.spec_accepted_sum / eng.spec_rows <= eng.spec_k + 1
    if rounds == 4:
        assert eng.spec_dispatches > eng._dispatch_count - eng.stat_decode_dispatches
    if eng.paged:
        owned = [p for pages in eng._slot_pages for p in pages]
        assert len(owned) + len(eng._free_pages) == eng.num_pages


def test_spec_engine_matches_jax_spec_engine(setup):
    """The JAX speculative engine on the same weights and requests (slots,
    K 4, 2-round blocks): the same tokens as the port's."""
    jcfg, tcfg, jp, tp, batches, expected, _ = setup
    jeng = jserve.ServingEngine(
        jp, jcfg, num_slots=4, max_seq_len=128, cache_dtype=jnp.float32,
        prefill_len_buckets=(64, 128), mel_len_buckets=(400,), cache_mode="slots",
        spec_decode="ngram", spec_k=4, decode_block_steps=2, spec_min_accept=0)
    jgot = _serve(jeng, batches, max_tokens=MAX_NEW)
    eng = _engine(tp, tcfg, decode_block_steps=2, spec_min_accept=0)
    assert _serve(eng, batches, max_tokens=MAX_NEW) == jgot == [(e, "length") for e in expected]
    assert jeng.spec_dispatches > 0 and eng.spec_dispatches > 0


def test_spec_equals_non_spec_engine_with_audio_and_reuse(setup):
    """An audio prompt, then a second turn that reuses its prefix: the
    speculative engine's tokens equal the same engine's without
    speculation, and the reuse stays engaged."""
    from tests.torch_parity import synth_audio
    from ultravox_torch.ops import mel as tmel

    _, tcfg, _, tp, _, _, _ = setup
    rng = np.random.default_rng(8)
    mel = tmel.log_mel_spectrogram_np(synth_audio(1.0, 2))
    av = np.zeros((1, mel.shape[0], 400), np.float32)
    av[0, :, : mel.shape[1]] = mel
    n_audio = -(-mel.shape[1] // 16)
    pat = rng.integers(1, 512, 4)
    ids1 = np.tile(pat, 10)[: 12 + n_audio][None].astype(np.int32)
    ids2 = np.concatenate([ids1, np.tile(pat, 3)[None].astype(np.int32)], axis=1)

    def mk(ids):
        return {"input_ids": ids, "attention_mask": np.ones_like(ids), "audio_values": av,
                "audio_lens": np.array([mel.shape[1]], np.int32),
                "audio_token_len": np.array([n_audio], np.int32),
                "audio_token_start_idx": np.array([4], np.int32),
                "audio_chunk_batch_idx": np.array([0], np.int32)}

    def run(**kw):
        eng = _engine(tp, tcfg, **kw)
        eng.start()
        try:
            out1 = _drain(eng, eng.submit(mk(ids1), max_tokens=12))
            out2 = _drain(eng, eng.submit(mk(ids2), max_tokens=12))
        finally:
            eng.stop()
        return out1, out2, eng

    base1, base2, _ = run(spec_decode=None)
    spec1, spec2, eng = run(spec_min_accept=0)
    assert (spec1, spec2) == (base1, base2)
    assert eng.reused_prefix_tokens > 0 and eng.spec_dispatches > 0


@pytest.mark.parametrize("kw", [
    dict(repetition_penalty=1.3), dict(logprobs=True), dict(temperature=0.8, seed=7),
])
def test_spec_disengages_for_single_step_options(setup, kw):
    """Penalties, logprobs and seeded sampling force single steps: the tokens
    equal a non-speculative engine's and speculation never runs."""
    _, tcfg, _, tp, batches, _, _ = setup
    base = _serve(_engine(tp, tcfg, spec_decode=None), batches[:1], max_tokens=10, **kw)
    eng = _engine(tp, tcfg, spec_min_accept=0)
    assert _serve(eng, batches[:1], max_tokens=10, **kw) == base
    assert eng.spec_dispatches == 0


def test_seeded_greedy_and_unseeded_sampling_speculate(setup):
    """A seed on a greedy request draws nothing, so it speculates and keeps
    the greedy tokens; an unseeded sampled request speculates beside it and
    finishes with in-vocabulary tokens."""
    _, tcfg, _, tp, batches, expected, _ = setup
    eng = _engine(tp, tcfg, spec_min_accept=0)
    eng.start()
    try:
        r1 = eng.submit(dict(batches[0]), max_tokens=MAX_NEW, seed=123)
        r2 = eng.submit(dict(batches[1]), max_tokens=MAX_NEW, temperature=0.9)
        ids1, fin1 = _drain(eng, r1)
        ids2, fin2 = _drain(eng, r2)
    finally:
        eng.stop()
    assert ids1 == expected[0] and fin1 == "length"
    assert len(ids2) == MAX_NEW and fin2 == "length"
    assert all(0 <= t < tcfg.text_config.vocab_size for t in ids2)
    assert eng.spec_dispatches > 0


def test_spec_with_churn_and_stop_tokens(setup):
    """A request arriving mid-speculation (disengage for its prefill, then a
    history resync) and a stop token that cuts an accepted run short."""
    _, tcfg, _, tp, batches, expected, jeng = setup
    exp2_free = jeng.generate(batches[1], max_new_tokens=MAX_NEW).token_ids[0]
    stop = exp2_free[5]
    exp2 = exp2_free[: exp2_free.index(stop)]
    eng = _engine(tp, tcfg, num_slots=2, decode_block_steps=4, spec_min_accept=0)
    eng.start()
    try:
        r1 = eng.submit(dict(batches[0]), max_tokens=MAX_NEW)
        got1 = []
        for ev in eng.stream(r1, timeout=120):
            if ev.token_id is None:
                break
            got1.append(ev.token_id)
            if len(got1) == 6:
                r2 = eng.submit(dict(batches[1]), max_tokens=MAX_NEW, stop_token_ids=(stop,))
        got2, fin2 = _drain(eng, r2)
    finally:
        eng.stop()
    assert got1 == expected[0]
    assert got2 == exp2 and fin2 == "stop"
    assert eng.spec_syncs >= 2


def test_spec_composes_with_multi_lora(setup):
    """An LM adapter beside the base model: each request's tokens equal the
    JAX GenerationEngine's on the base tree and on the adapted tree."""
    from ultravox_tpu.models import lora as jlora
    from ultravox_tpu.models.config import LoraConfig

    jcfg, tcfg, jp, tp, batches, expected, _ = setup
    lm = jlora.add_lora(jp["language_model"], LoraConfig(r=4, target_modules=("q_proj", "v_proj")),
                        jax.random.key(11), jlora.DECODER_TARGETS)
    for tgt in ("q_proj", "v_proj"):
        shp = lm["layers"][tgt]["lora_b"].shape
        lm["layers"][tgt]["lora_b"] = jax.random.normal(jax.random.key(101), shp) * 0.5
    exp_ad = JEngine(dict(jp, language_model=lm), jcfg, max_cache_len=160,
                     cache_dtype=jnp.float32).generate(batches[0], max_new_tokens=MAX_NEW).token_ids[0]
    adapters = {"styled": from_jax_params(
        {"language_model": jax.tree.map(np.asarray, lm)}, tcfg)}
    eng = _engine(tp, tcfg, lora_adapters=adapters, spec_min_accept=0)
    eng.start()
    try:
        r_base = eng.submit(dict(batches[0]), max_tokens=MAX_NEW)
        r_ad = eng.submit(dict(batches[0]), max_tokens=MAX_NEW, lora="styled")
        got_base, _ = _drain(eng, r_base)
        got_ad, _ = _drain(eng, r_ad)
    finally:
        eng.stop()
    assert got_base == expected[0]
    assert got_ad == exp_ad and got_ad != got_base
    assert eng.spec_dispatches > 0


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_spec_decode_to_cache_edge(setup, mode):
    """Asked for more than fits: multi-round, then single rounds, then single
    steps at the edge; tokens equal to the JAX generate until cache_full."""
    _, tcfg, _, tp, batches, _, jeng = setup
    max_len = 96
    prompt_len = int(batches[0]["attention_mask"].sum())
    room = max_len - 1 - prompt_len
    exp = jeng.generate(batches[0], max_new_tokens=room).token_ids[0]
    eng = _engine(tp, tcfg, cache_mode=mode, max_seq_len=max_len, prefill_len_buckets=(64,),
                  decode_block_steps=4, spec_min_accept=0)
    [(ids, fin)] = _serve(eng, batches[:1], max_tokens=500)
    assert fin == "cache_full"
    assert len(ids) == room and ids == exp[: len(ids)]
    assert eng.spec_single_dispatches > 0 and eng.stat_decode_dispatches > 0


def test_spec_autopause_and_reprobe(setup):
    """A floor above K+1 must pause speculation once the probe's window is
    full, re-probe after the period, back off after failed probes, and
    never change the tokens."""
    _, tcfg, _, tp, batches, _, jeng = setup
    n = 80
    exp = jeng.generate(batches[2], max_new_tokens=n).token_ids[0]
    eng = _engine(tp, tcfg, spec_min_accept=6.0, spec_probe_period=4)
    [(ids, fin)] = _serve(eng, batches[2:], max_tokens=n)
    assert ids == exp and fin == "length"
    assert eng.spec_autopauses >= 2 and eng.spec_probe_dispatches >= 4
    assert eng._spec_fail_streak >= 1
    assert eng.stat_decode_dispatches > 0
    # _reset_spec_guard restores the constructor's cold start
    eng._reset_spec_guard()
    fresh = _engine(tp, tcfg, spec_min_accept=6.0, spec_probe_period=4)
    for k in ("_spec_probe_mode", "_spec_paused_flag", "_spec_resume_at", "_spec_fail_streak"):
        assert getattr(eng, k) == getattr(fresh, k)
    assert eng._spec_probe_mode and not eng._spec_window


def test_spec_health_window_keeps_multi_round_when_healthy(setup):
    """With the default floor the cold-start probe passes on this workload
    (acceptance above 1.35), so multi-round dispatches follow."""
    _, tcfg, _, tp, batches, expected, _ = setup
    eng = _engine(tp, tcfg, decode_block_steps=4)
    got = _serve(eng, batches, max_tokens=MAX_NEW)
    assert got == [(e, "length") for e in expected]
    assert eng.spec_probe_dispatches >= 1
    assert eng.spec_dispatches > eng.spec_probe_dispatches + eng.spec_single_dispatches
