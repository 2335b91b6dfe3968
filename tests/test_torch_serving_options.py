"""The port's ServingEngine request options on the CPU, against the JAX
package's ServingEngine.

On the same weights (fp32): greedy tokens of requests with presence /
frequency / repetition penalties and ``logit_bias`` (forcing, banning, and
a forced first token that the presence penalty then suppresses) equal the
JAX ServingEngine's, in slots and paged modes with 4-step blocks enabled,
and their logprobs (chosen and top-5, with and without penalties) are within
1e-4 with the same top ids (the mirrors of tests/test_serving.py's
test_sampling_penalties, test_logit_bias,
test_presence_penalty_counts_first_token and test_serving_logprobs_engine).
``apply_penalties`` and ``token_logprobs`` match JAX's within 1e-6. Seeded
sampling is held by distribution (threefry cannot be reproduced): a TV
distance test like tests/test_spec_decode.py's, then batch independence,
seed normalisation and the single-step gate. Precomputed ``audio_embeds``
give the tokens of the same audio request.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import make_configs, make_params, synth_audio
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.ops import mel as tmel
from ultravox_torch.ops import sampling as tsamp
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.ops import sampling as jsamp

MAX_NEW = 10
FORCED = 7
ENGINE = dict(num_slots=4, max_seq_len=128, prefill_len_buckets=(64, 128), mel_len_buckets=(400,),
              prefill_chunk_tokens=16, decode_block_steps=4)


def _batch(rng, n_tokens, audio_seconds=None, compression=1):
    """One request: random prompt ids, with the audio (padded to 400 mel
    frames) spliced at position 4 when ``audio_seconds`` is given."""
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


def _options(prompt_ids):
    """(batch index, submit options) of the mixed-option requests."""
    return [
        (0, {}),
        (0, dict(repetition_penalty=1.3, presence_penalty=0.5, frequency_penalty=0.5)),
        (0, dict(logit_bias={FORCED: 100.0})),
        (1, dict(logit_bias={t: -100.0 for t in prompt_ids[:6]})),
        (0, dict(logit_bias={FORCED: 20.0}, presence_penalty=100.0)),
        (1, dict(logprobs=True, top_logprobs=5)),
        (0, dict(logprobs=True, top_logprobs=2, repetition_penalty=1.3)),
        (0, dict(repetition_penalty=1e9)),
    ]


def _collect(engine, batches, options):
    """Submit every request at once; per request (ids, finish, events)."""
    engine.start()
    try:
        reqs = [engine.submit(dict(batches[b]), max_tokens=MAX_NEW, **kw) for b, kw in options]
        out = []
        for r in reqs:
            evs, finish = [], None
            for ev in engine.stream(r, timeout=300):
                if ev.token_id is None:
                    finish = ev.finish_reason
                    break
                evs.append(ev)
            out.append(([e.token_id for e in evs], finish, evs))
        return out
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def setup():
    """Configs, weights, two requests (one with audio), the options and the
    JAX ServingEngine's results for them."""
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    rng = np.random.default_rng(0)
    batches = [_batch(rng, 20), _batch(rng, 33, 1.5, jcfg.audio_token_compression)]
    options = _options([int(t) for t in batches[0]["input_ids"][0]])
    jeng = jserve.ServingEngine(jparams, jcfg, cache_dtype=jnp.float32, cache_mode="slots",
                                **ENGINE)
    expected = _collect(jeng, batches, options)
    assert all(f == "length" for _, f, _ in expected)
    return tcfg, tparams, batches, options, expected


def _tengine(tparams, tcfg, mode, **kw):
    args = dict(ENGINE, cache_mode=mode, cache_dtype=torch.float32, device="cpu")
    if mode == "paged":
        args["page_size"] = 16
    args.update(kw)
    return tserve.ServingEngine(tparams, tcfg, **args)


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_options_match_jax_serving(setup, mode):
    """Every request's greedy tokens equal the JAX engine's, and the
    options do what they promise: +100 forces its id at every step, -100
    bans its ids, the forced first token is counted by the presence penalty
    from the next step on, a huge repetition penalty never emits a prompt
    token or repeats."""
    tcfg, tparams, batches, options, expected = setup
    got = _collect(_tengine(tparams, tcfg, mode), batches, options)
    for i, ((ids, fin, _), (want, _, _)) in enumerate(zip(got, expected)):
        assert fin == "length" and ids == want, (i, options[i][1], ids, want)
    assert got[2][0] == [FORCED] * MAX_NEW
    assert not set(got[3][0]) & set(options[3][1]["logit_bias"])
    assert got[4][0][0] == FORCED and FORCED not in got[4][0][1:]
    prompt = set(batches[0]["input_ids"][0].tolist())
    rep = got[7][0]
    assert len(set(rep)) == len(rep) and not set(rep) & prompt
    assert len(set(got[0][0])) > 3, "degenerate tokens prove little"


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_logprobs_match_jax_serving(setup, mode):
    """Logprobs arrive for every token, the first included: within 1e-4 of
    the JAX engine's with the same top ids; greedy picks the top-1, whose
    logprob is the chosen one's; requests without logprobs get none."""
    tcfg, tparams, batches, options, expected = setup
    got = _collect(_tengine(tparams, tcfg, mode), batches, options)
    for i, (_, kw) in enumerate(options):
        evs, jevs = got[i][2], expected[i][2]
        if not kw.get("logprobs"):
            assert all(e.logprob is None and e.top_ids is None for e in evs)
            continue
        assert len(evs) == MAX_NEW
        for e, j in zip(evs, jevs):
            assert e.top_ids == j.top_ids and len(e.top_ids) == kw["top_logprobs"]
            assert abs(e.logprob - j.logprob) < 1e-4
            np.testing.assert_allclose(e.top_logprobs, j.top_logprobs, atol=1e-4)
            assert e.top_ids[0] == e.token_id and e.top_logprobs[0] == e.logprob
            assert list(e.top_logprobs) == sorted(e.top_logprobs, reverse=True)


def test_apply_penalties_and_token_logprobs_match_jax():
    """fp32 within 1e-6, the same top ids; a 0 / 0 / 1 row (with stale
    counts) is an exact no-op; a repetition penalty <= 0 counts as 1."""
    rng = np.random.default_rng(1)
    B, V = 5, 300
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    mask = rng.random((B, V)) < 0.2
    samp = np.array([[0.7, 0, 1, 0, 0.5, 0.3, 1.3], [0, 0, 1, 0, 0, 0, 1],
                     [1, 5, 0.9, 0, 1.0, 2.0, 0.8], [0, 0, 1, 0, 0, 0, -1],
                     [0, 0, 1, 0, 0.0, 0.7, 1.0]], np.float32)
    want = np.array(jsamp.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                            jnp.asarray(mask), jnp.asarray(samp)))
    got = tsamp.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts),
                                torch.from_numpy(mask), torch.from_numpy(samp)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.array_equal(got[1], logits[1]) and np.array_equal(got[3], logits[3])
    sampled = rng.integers(0, V, (B,)).astype(np.int32)
    jl = jsamp.token_logprobs(jnp.asarray(want), jnp.asarray(sampled))
    tl = tsamp.token_logprobs(torch.from_numpy(want), torch.from_numpy(sampled))
    assert tsamp.MAX_TOP_LOGPROBS == jsamp.MAX_TOP_LOGPROBS == 5
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]), atol=1e-6, rtol=0)
    assert np.array_equal(tl[1].numpy(), np.asarray(jl[1]))
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), atol=1e-6, rtol=0)


def test_seeded_draws_follow_the_distribution():
    """sample_slots' seeded rows draw from the filtered softmax: the total
    variation distance of 40k draws (one per seed, and one per position of
    one seed) from p is under 0.02; top-k 3 never draws outside the top 3;
    the noise is Exp(1) (mean and variance within 2%), repeats for the
    same (seed, position) and moves with either."""
    Vs, N = 8, 40_000
    rng = np.random.default_rng(3)
    row = rng.standard_normal(Vs).astype(np.float32)
    p = np.exp(row) / np.exp(row).sum()
    logits = torch.from_numpy(np.tile(row, (N, 1)))
    samp = torch.tensor([[1.0, 0, 1.0, 0]] * N)
    cases = ((torch.arange(N, dtype=torch.int32), torch.full((N,), 5, dtype=torch.int32)),
             (torch.full((N,), 7, dtype=torch.int32), torch.arange(N, dtype=torch.int32)))
    for seeds, pos in cases:
        toks = tsamp.sample_slots(logits, samp, None, sampled=True, filtered=False,
                                  seeds=seeds, positions=pos).numpy()
        tv = 0.5 * np.abs(np.bincount(toks, minlength=Vs) / N - p).sum()
        assert tv < 0.02, tv
    k3 = torch.tensor([[1.0, 3, 1.0, 0]] * N)
    toks = tsamp.sample_slots(logits, k3, None, sampled=True, filtered=True,
                              seeds=cases[0][0], positions=cases[0][1]).numpy()
    assert set(toks) <= set(np.argsort(-row)[:3].tolist())
    e = tsamp.seeded_exponential(torch.tensor([1, 1, 2]), torch.tensor([3, 4, 3]), 200_000)
    assert e.dtype == torch.float32 and bool((e > 0).all())
    for r in e:
        assert abs(float(r.mean()) - 1) < 0.02 and abs(float(r.var()) - 1) < 0.02
    again = tsamp.seeded_exponential(torch.tensor([1]), torch.tensor([3]), 200_000)
    assert torch.equal(again[0], e[0])
    assert not torch.equal(e[0], e[1]) and not torch.equal(e[0], e[2])


def _seeded_run(tparams, tcfg, batches, seed, *, noise, mode="slots", block_steps=4,
                temperature=0.8):
    eng = _tengine(tparams, tcfg, mode, decode_block_steps=block_steps)
    opts = [(1, dict(temperature=1.0))] * noise + [
        (0, dict(temperature=temperature, top_p=0.9, seed=seed))]
    return _collect(eng, batches, opts)[-1][0]


def test_seeded_sampling_is_batch_independent(setup):
    """A seeded request at temperature 0.8 gives the same tokens alone or
    beside unseeded sampled requests, in either cache mode and with or
    without blocks enabled; another seed gives other tokens."""
    tcfg, tparams, batches, _, _ = setup
    alone = _seeded_run(tparams, tcfg, batches, 1234, noise=0)
    assert len(alone) == MAX_NEW
    assert _seeded_run(tparams, tcfg, batches, 1234, noise=2) == alone
    assert _seeded_run(tparams, tcfg, batches, 1234, noise=3, mode="paged", block_steps=1) == alone
    assert any(_seeded_run(tparams, tcfg, batches, s, noise=0) != alone for s in (7, 99, 4242))


def test_seed_normalization_negative_and_huge(setup):
    """Any int is a legal seed: a negative one does not collide with the
    unseeded sentinel (it repeats), a 64-bit one does not overflow int32,
    and both reduce as the JAX package's do (mod 0x7FFFFFFF)."""
    tcfg, tparams, batches, _, _ = setup
    for seed in (-1, 2**40 + 3):
        eng = _tengine(tparams, tcfg, "slots")
        assert eng.submit(dict(batches[0]), seed=seed).seed == seed % 0x7FFFFFFF
        first = _seeded_run(tparams, tcfg, batches, seed, noise=0, temperature=0.9)
        assert len(first) == MAX_NEW
        assert _seeded_run(tparams, tcfg, batches, seed, noise=1, temperature=0.9) == first
    with pytest.raises(ValueError, match="top_logprobs"):
        _tengine(tparams, tcfg, "slots").submit(dict(batches[0]), top_logprobs=6)
    with pytest.raises(ValueError, match="at most 32"):
        _tengine(tparams, tcfg, "slots").submit(dict(batches[0]),
                                                logit_bias={t: 1.0 for t in range(33)})


@pytest.mark.parametrize("opt", [dict(presence_penalty=0.5), dict(logprobs=True),
                                 dict(seed=3, temperature=0.8), dict(seed=3)])
def test_single_step_gate(setup, opt):
    """Decode blocks disengage while a request that needs single steps is
    active (a seeded greedy request rides blocks); the plain request beside
    it keeps the tokens it has alone."""
    tcfg, tparams, batches, _, expected = setup
    eng = _tengine(tparams, tcfg, "paged")
    eng.start()
    try:
        plain = eng.submit(dict(batches[0]), max_tokens=24)
        other = eng.submit(dict(batches[1]), max_tokens=24, **opt)
        ids = [t for t in (e.token_id for e in eng.stream(plain, timeout=300)) if t is not None]
        list(eng.stream(other, timeout=300))
    finally:
        eng.stop()
    assert ids[:MAX_NEW] == expected[0][0]
    blocks = eng.stat_decode_steps - eng.stat_decode_dispatches
    assert (blocks == 0) == tserve._needs_single_step(tserve.Request(0, {}, **opt))


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_precomputed_audio_embeds_match_audio(setup, mode):
    """A request with precomputed ``audio_embeds`` (the port's encoder and
    projector on its mel) and no ``audio_values`` gives the greedy tokens
    of the same request with its audio; the embeddings' fingerprint keeps a
    retained prefix from matching other embeddings at the same
    placeholders, and lets the same ones reuse it."""
    tcfg, tparams, batches, _, expected = setup
    audio = batches[1]
    with torch.inference_mode():
        ae = tuv.encode_audio(tparams, tcfg, torch.from_numpy(audio["audio_values"]),
                              torch.from_numpy(audio["audio_lens"]))
    text = {k: v for k, v in audio.items() if k not in ("audio_values", "audio_lens")}
    eng = _tengine(tparams, tcfg, mode)
    eng.start()
    try:
        reqs = [eng.submit(dict(audio), max_tokens=MAX_NEW)]
        ids = [[t for t in (e.token_id for e in eng.stream(reqs[0], timeout=300)) if t is not None]]
        for emb in (ae, ae.numpy() + 1.0, ae.numpy()):
            r = eng.submit(dict(text), max_tokens=MAX_NEW, audio_embeds=emb)
            ids.append([t for t in (e.token_id for e in eng.stream(r, timeout=300))
                        if t is not None])
            reqs.append(r)
    finally:
        eng.stop()
    assert len(ids[0]) == MAX_NEW and ids[1] == ids[0] == ids[3]
    assert ids[2] != ids[0]
    # spans start at the splice: the first two tokens prefix-match any
    # request, the audio only identical embeddings
    assert reqs[2].reused_prefix <= 4 and reqs[3].reused_prefix > 4
