"""The port's ServingEngine on the CPU, against the JAX package.

Greedy tokens of three requests (one with audio) through the port's
ServingEngine equal the JAX GenerationEngine's on the same weights (fp32,
exact), in slots and paged modes (the paged pool smaller than the slots'
token count), with single steps and 4-step blocks, and with the XLA forms
and the kernels' plain versions; a gemma-3-style decoder with sliding
windows likewise in paged mode. Then stop tokens inside a block, sampled
requests beside greedy ones, cancellation, pool backpressure, conversation
reuse, ``_resolve_auto`` against JAX's, every request option accepted, and
the engine options that are not ported or are checked elsewhere (multi-LoRA and int8 serving: tests/test_torch_lora_serving.py and
tests/test_torch_int8.py). Page accounting is checked after every paged run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import make_configs, make_params, synth_audio
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.ops import mel as tmel
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.inference.serving import engine as jserve

MAX_NEW = 12


def _batch(rng, n_tokens: int, audio_seconds=None, compression: int = 1):
    """One request: ``n_tokens`` random prompt ids, with the audio (padded to
    400 mel frames) spliced at position 4 when ``audio_seconds`` is given."""
    ids = rng.integers(1, 512, (1, n_tokens)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    if audio_seconds is not None:
        mel = tmel.log_mel_spectrogram_np(synth_audio(audio_seconds, 3))
        av = np.zeros((1, mel.shape[0], 400), np.float32)
        av[0, :, : mel.shape[1]] = mel
        lens = np.array([mel.shape[1]], np.int32)
        batch.update(
            audio_values=av, audio_lens=lens,
            audio_token_len=(-(-lens // compression)).astype(np.int32),
            audio_token_start_idx=np.array([4], np.int32),
            audio_chunk_batch_idx=np.array([0], np.int32),
        )
    return batch


@pytest.fixture(scope="module")
def setup():
    """Configs, weights, three requests and the JAX engine's greedy tokens."""
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    comp = jcfg.audio_token_compression
    batches = [_batch(rng, 20), _batch(rng, 33, 1.5, comp), _batch(rng, 9)]
    jeng = JEngine(jparams, jcfg, max_cache_len=128, cache_dtype=jnp.float32)
    expected = [jeng.generate(b, max_new_tokens=MAX_NEW).token_ids[0] for b in batches]
    assert all(len(set(e)) > 3 for e in expected), "degenerate tokens prove little"
    return jcfg, tcfg, jparams, tparams, batches, expected


def _engine(tparams, tcfg, **kw):
    base = dict(num_slots=4, max_seq_len=128, cache_dtype=torch.float32, device="cpu",
                prefill_len_buckets=(64, 128), mel_len_buckets=(400,), prefill_chunk_tokens=16,
                page_size=16)
    base.update(kw)
    if base.get("cache_mode") == "slots":
        base.pop("page_size")
    return tserve.ServingEngine(tparams, tcfg, **base)


def _drain(engine, req):
    ids, finish = [], None
    for ev in engine.stream(req, timeout=120):
        if ev.token_id is None:
            finish = ev.finish_reason
            break
        ids.append(ev.token_id)
    return ids, finish


def _check_page_accounting(engine):
    if not engine.paged:
        return
    owned = [p for pages in engine._slot_pages for p in pages]
    assert len(owned) + len(engine._free_pages) == engine.num_pages
    assert len(set(engine._free_pages)) == len(engine._free_pages)
    assert len(set(owned)) == len(owned)  # exclusive ownership
    assert not set(owned) & set(engine._free_pages)
    table = engine._table_np
    for slot, pages in enumerate(engine._slot_pages):
        assert table[slot, : len(pages)].tolist() == pages
        assert (table[slot, len(pages):] == engine.num_pages).all()


def _serve(engine, batches, **submit_kw):
    engine.start()
    try:
        reqs = [engine.submit(dict(b), **submit_kw) for b in batches]
        out = [_drain(engine, r) for r in reqs]
        _check_page_accounting(engine)
    finally:
        engine.stop()
    return out


@pytest.mark.parametrize("block_impl", ["xla", "kernel"])
@pytest.mark.parametrize("block_steps", [1, 4])
@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_serving_matches_jax_generate(setup, mode, block_steps, block_impl):
    """With "kernel", single steps also run the decode kernels' plain
    versions (decode_attention / paged_decode_attention)."""
    _, tcfg, _, tparams, batches, expected = setup
    kw = dict(cache_mode=mode, decode_block_steps=block_steps, block_attn_impl=block_impl,
              decode_attn_impl="kernel" if block_impl == "kernel" else "xla",
              encoder_attn_impl="fused", prefill_attn_impl="fused")
    if mode == "paged":
        kw["num_pages"] = 20  # the slots' token count would be 4 x 8 pages
    eng = _engine(tparams, tcfg, **kw)
    out = _serve(eng, batches, max_tokens=MAX_NEW)
    assert [ids for ids, _ in out] == expected
    assert [f for _, f in out] == ["length"] * 3
    assert eng.stat_prefill_chunks >= 5  # the 33-token prompt took 3 chunks
    if block_steps > 1:
        assert eng.stat_decode_steps > eng.stat_decode_dispatches  # blocks ran


def test_serving_with_flash_encoder_matches_jax_generate(setup):
    """encoder_attn_impl="flash": the admission's encoder runs its attention
    in flash_attention (the plain version here); greedy tokens equal the JAX
    GenerationEngine's with the same option."""
    jcfg, tcfg, jparams, tparams, batches, _ = setup
    jeng = JEngine(jparams, jcfg, max_cache_len=128, cache_dtype=jnp.float32,
                   encoder_attn_impl="flash")
    expected = [jeng.generate(b, max_new_tokens=MAX_NEW).token_ids[0] for b in batches]
    eng = _engine(tparams, tcfg, cache_mode="paged", decode_block_steps=4,
                  encoder_attn_impl="flash")
    out = _serve(eng, batches, max_tokens=MAX_NEW)
    assert [ids for ids, _ in out] == expected
    assert [f for _, f in out] == ["length"] * 3


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_stop_token_inside_a_block(setup, mode):
    """A stop token sampled mid-block finishes the request with "stop"; the
    block's later columns are dropped and the other requests go on."""
    _, tcfg, _, tparams, batches, expected = setup
    j = next(i for i in range(5, MAX_NEW) if expected[0][i] not in expected[0][:i])
    eng = _engine(tparams, tcfg, cache_mode=mode, decode_block_steps=4)
    eng.start()
    try:
        first = eng.submit(dict(batches[0]), max_tokens=MAX_NEW, stop_token_ids=(expected[0][j],))
        ids, finish = _drain(eng, first)
        rest = [_drain(eng, eng.submit(dict(b), max_tokens=MAX_NEW)) for b in batches[1:]]
        _check_page_accounting(eng)
    finally:
        eng.stop()
    assert (ids, finish) == (expected[0][:j], "stop")
    assert [r[0] for r in rest] == expected[1:]


def test_sampled_requests_beside_greedy(setup):
    """Temperature, top-k, top-p and min-p requests share decode calls with a
    greedy one: the greedy request keeps the JAX tokens, the sampled ones
    finish with in-range tokens."""
    _, tcfg, _, tparams, batches, expected = setup
    eng = _engine(tparams, tcfg, cache_mode="paged", decode_block_steps=4)
    samplers = [dict(temperature=0.8), dict(temperature=1.0, top_k=5), dict(temperature=0.7, top_p=0.9),
                dict(temperature=0.9, min_p=0.1)]
    eng.start()
    try:
        reqs = [eng.submit(dict(batches[0]), max_tokens=MAX_NEW)]
        reqs += [eng.submit(dict(batches[2]), max_tokens=MAX_NEW, **s) for s in samplers]
        out = [_drain(eng, r) for r in reqs]
        _check_page_accounting(eng)
    finally:
        eng.stop()
    assert out[0] == (expected[0], "length")
    for ids, finish in out[1:]:
        assert finish == "length" and len(ids) == MAX_NEW
        assert all(0 <= t < tcfg.vocab_size for t in ids)


def test_cancel_releases_pages_and_acknowledges(setup):
    """Cancelling an active request frees its slot and pages at once;
    cancelling a pending one acknowledges it before admission."""
    _, tcfg, _, tparams, batches, _ = setup
    eng = _engine(tparams, tcfg, cache_mode="paged", num_slots=1)
    eng.start()
    try:
        active = eng.submit(dict(batches[0]), max_tokens=100)
        pending = eng.submit(dict(batches[2]), max_tokens=4)
        events = eng.stream(active, timeout=120)
        assert next(events).token_id is not None  # decoding now
        eng.cancel(pending)
        eng.cancel(active)
        rest = list(events)
        assert rest[-1].finish_reason == "cancelled"
        assert _drain(eng, pending) == ([], "cancelled")
        assert eng.pages_in_use == 0
        _check_page_accounting(eng)
        after = _drain(eng, eng.submit(dict(batches[2]), max_tokens=4))
        assert after[1] == "length" and len(after[0]) == 4
        _check_page_accounting(eng)
    finally:
        eng.stop()


def test_paged_pool_backpressure_and_exhaustion(setup):
    """A pool holding one request at a time still serves three (later ones
    wait for pages, retained conversations are evicted); a request larger
    than the whole pool fails with "pool_exhausted"."""
    _, tcfg, _, tparams, batches, expected = setup
    eng = _engine(tparams, tcfg, cache_mode="paged", max_seq_len=64, prefill_len_buckets=(64,),
                  num_pages=2)
    out = _serve(eng, [batches[0], batches[2], batches[0]], max_tokens=6)
    assert out == [(expected[0][:6], "length"), (expected[2][:6], "length"),
                   (expected[0][:6], "length")]
    small = _engine(tparams, tcfg, cache_mode="paged", max_seq_len=64, prefill_len_buckets=(64,),
                    num_pages=1)
    assert _serve(small, [batches[0]], max_tokens=32) == [([], "pool_exhausted")]


def test_prompt_too_long(setup):
    _, tcfg, _, tparams, _, _ = setup
    ids = np.ones((1, 64), np.int32)
    eng = _engine(tparams, tcfg, cache_mode="slots", max_seq_len=64, prefill_len_buckets=(64,))
    assert _serve(eng, [{"input_ids": ids, "attention_mask": ids}]) == [([], "prompt_too_long")]


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_conversation_reuse_matches_fresh_engine(setup, mode):
    """Turn 2 extends turn 1's prompt and reply. While another request
    decodes beside the retained turn 1 (inactive-slot writes must not touch
    it), turn 2 reuses its prefix and gives a fresh engine's tokens. In
    paged mode the adoption copies the prefix, so turn 1's pages survive
    and a third request reuses them too."""
    _, tcfg, _, tparams, batches, _ = setup
    prompt = batches[0]["input_ids"]
    eng = _engine(tparams, tcfg, cache_mode=mode, num_slots=2)
    eng.start()
    try:
        ids1, _ = _drain(eng, eng.submit(dict(batches[0]), max_tokens=4))
        _drain(eng, eng.submit(dict(batches[2]), max_tokens=20))  # decodes beside turn 1
        turn2 = np.concatenate([prompt, np.array([ids1], np.int32), prompt[:, :7]], axis=1)
        b2 = {"input_ids": turn2, "attention_mask": np.ones_like(turn2)}
        r2 = eng.submit(dict(b2), max_tokens=6)
        ids2, _ = _drain(eng, r2)
        assert r2.reused_prefix >= prompt.shape[1] + 3
        if mode == "paged":
            assert any(len(e.token_ids) == prompt.shape[1] + 3 for e in eng._retained.values())
            r3 = eng.submit(dict(b2), max_tokens=6)
            assert _drain(eng, r3)[0] == ids2 and r3.reused_prefix > 0
        _check_page_accounting(eng)
    finally:
        eng.stop()
    fresh = _engine(tparams, tcfg, cache_mode=mode, num_slots=2)
    assert _serve(fresh, [b2], max_tokens=6)[0][0] == ids2


@pytest.mark.parametrize("on_card", [False, True])
def test_resolve_auto_matches_jax(setup, monkeypatch, on_card):
    """Every "auto" choice equals the JAX package's, off the card (its CPU
    answer) and on it (its TPU answer), across context lengths, KV widths
    and a softcapped config."""
    jcfg, tcfg, *_ = setup
    if on_card:
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for changes in ({}, dict(num_kv_heads=8, num_heads=32, head_dim=128),
                    dict(num_kv_heads=8, num_heads=32, head_dim=128, attn_logit_softcapping=50.0)):
        jt = dataclasses.replace(jcfg.text_config, **changes)
        tt = dataclasses.replace(tcfg.text_config, **changes)
        for max_seq_len in (512, 1024, 2048, 8192):
            for explicit in ({}, dict(cache_mode="slots", block_attn_impl="kernel",
                                      decode_block_steps=2)):
                args = dict(cache_mode="auto", decode_attn_impl="auto", prefill_attn_impl="auto",
                            encoder_attn_impl="auto", block_attn_impl="auto",
                            decode_block_steps=None, max_seq_len=max_seq_len)
                args.update(explicit)
                want = jserve._resolve_auto(**args, text_config=jt)
                got = tserve._resolve_auto(**args, text_config=tt, on_card=on_card)
                assert got == want, (changes, max_seq_len, explicit)


@pytest.mark.parametrize("kw", [
    dict(quantize="int4"), dict(lora_adapters={"a": {}}), dict(spec_decode="ngram"),
    dict(mesh=object(), quantize="int8"), dict(encoder_attn_impl="bogus"),
])
def test_unported_engine_options_raise(setup, kw):
    """A mesh with int8 weights raises ValueError, as in the JAX package
    (meshes serve: tests/test_torch_parallel_tensor.py); an unknown quantize
    mode or encoder_attn_impl and adapters without LoRA leaves raise
    ValueError, as in the JAX package (int8 and multi-LoRA serving run:
    tests/test_torch_int8.py, tests/test_torch_lora_serving.py).
    Speculative decoding is ported (tests/test_torch_spec_decode.py): "ngram"
    constructs and an unknown mode raises ValueError."""
    _, tcfg, _, tparams, _, _ = setup
    if "spec_decode" in kw:
        eng = tserve.ServingEngine(tparams, tcfg, device="cpu", **kw)
        assert eng.spec_decode == "ngram" and eng.token_hist is not None
        with pytest.raises(ValueError, match="spec_decode"):
            tserve.ServingEngine(tparams, tcfg, device="cpu", spec_decode="bogus")
        return
    if "mesh" in kw:
        with pytest.raises(ValueError, match="quantize= is not supported together with mesh="):
            tserve.ServingEngine(tparams, tcfg, device="cpu", **kw)
        return
    with pytest.raises(ValueError, match="quantize|no lora_a|encoder_attn_impl"):
        tserve.ServingEngine(tparams, tcfg, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(presence_penalty=0.5), dict(frequency_penalty=0.5), dict(repetition_penalty=1.2),
    dict(logit_bias={3: 1.0}), dict(logprobs=True), dict(top_logprobs=2),
    dict(seed=7, temperature=0.8), dict(lora="a"), dict(audio_embeds=np.zeros((1, 4, 128))),
])
def test_unported_request_options_raise(setup, kw):
    """Every request option of the JAX engine's ``submit`` is accepted (the
    name dates from when the port refused them): each request finishes
    "length" with its tokens, and the options that leave greedy decoding
    alone (logprobs, an empty audio splice) give the JAX engine's tokens.
    ``lora`` names an adapter this engine lacks, so that request finishes
    "unknown_lora", as in the JAX package. The options' tokens against the
    JAX ServingEngine: tests/test_torch_serving_options.py."""
    _, tcfg, _, tparams, batches, expected = setup
    eng = _engine(tparams, tcfg, cache_mode="slots")
    if "lora" in kw:
        assert _serve(eng, [batches[0]], **kw) == [([], "unknown_lora")]
        return
    [(ids, finish)] = _serve(eng, [batches[0]], max_tokens=MAX_NEW, **kw)
    assert finish == "length" and len(ids) == MAX_NEW
    assert all(0 <= t < tcfg.vocab_size for t in ids)
    if set(kw) <= {"logprobs", "top_logprobs", "audio_embeds"}:
        assert ids == expected[0]


def test_default_device_is_cuda_and_never_falls_back(setup, monkeypatch):
    _, tcfg, _, tparams, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ServingEngine(tparams, tcfg)


def test_gemma3_window_serving_matches_jax_generate():
    """A gemma-3-style decoder (window 8 on alternate layers, qk-norm,
    post-norms, final softcap) served paged with the kernels' plain versions
    in single steps and blocks: greedy tokens equal the JAX engine's."""
    from ultravox_torch.models import config as tc
    from ultravox_torch.models import decoder as tdec
    from ultravox_torch.models.weights import from_jax_params
    from ultravox_tpu.models import config as jc
    from ultravox_tpu.models import decoder as jdec

    fam = dict(arch="gemma3", vocab_size=384, hidden_size=48, intermediate_size=96, num_layers=3,
               num_heads=4, num_kv_heads=2, head_dim=12, sliding_window=8, sliding_window_pattern=2,
               qk_norm=True, use_post_norms=True, scale_embeddings=True, final_logit_softcapping=30.0,
               rope_local_base_freq=10000.0, rope_theta=1000000.0, query_pre_attn_scalar=16,
               hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True)
    jd, td = jc.DecoderConfig(**fam), tc.DecoderConfig(**fam)
    rng = np.random.default_rng(11)

    def draw(path, a):  # norm weights near 1, matrices at 4x the init scale
        x = rng.standard_normal(tuple(a.shape)).astype(np.float32)
        name = path[-1].key
        return 1.0 + 0.2 * x if ("norm" in name or name.endswith("_ln")) else 0.08 * x

    tree = jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(lambda: jdec.init_params(jd, jax.random.key(0))))
    jcfg = jc.UltravoxConfig(text_config=jd, llm_only_training=True)
    tcfg = tc.UltravoxConfig(text_config=td, llm_only_training=True)
    tparams = from_jax_params({"language_model": tree}, tcfg)
    assert set(tparams) == {"language_model"} and tdec.is_local_layer(td).tolist() == [True, False, True]
    batches = [_batch(rng, n) for n in (21, 14, 30)]
    for b in batches:
        b["input_ids"] %= 384
    jeng = JEngine({"language_model": jax.tree.map(jnp.asarray, tree)}, jcfg, max_cache_len=128,
                   cache_dtype=jnp.float32)
    expected = [jeng.generate(b, max_new_tokens=MAX_NEW).token_ids[0] for b in batches]
    assert all(len(set(e)) > 3 for e in expected), "degenerate tokens prove little"
    eng = _engine(tparams, tcfg, cache_mode="paged", decode_block_steps=4, decode_attn_impl="kernel",
                  block_attn_impl="kernel")
    assert [ids for ids, _ in _serve(eng, batches, max_tokens=MAX_NEW)] == expected
