"""The port's decode paths against the JAX package's, on the CPU.

- The plain versions of the decode and segment attention kernels against the
  Pallas kernels in interpret mode (the JAX package's own CPU route, patched
  in as tests/test_pallas.py does; nothing in ultravox_tpu changes).
  Tolerances: fp32 2e-5 absolute (the JAX kernel test's own; the two differ
  in summation order only); bf16 2^-6 relative plus 2^-6 absolute (a couple
  of bf16 ulps: an fp32 sum in another order can round to the next bf16).
- ``decoder_forward(decode_kernel=True)``, ``segmented_decode_scan`` and the
  engine's ``generate(decode_attn_impl="kernel")`` and ``generate_fused``
  against the JAX package: logits to 1e-4 absolute and relative (fp32, JAX
  at ``highest`` matmul precision, several layers summed in other orders),
  greedy tokens identical.
- The gemma-2, gemma-3 and qwen-3 families on the same terms.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import audio_batch, make_configs, make_params
from ultravox_torch.inference import engine as tengine
from ultravox_torch.models import config as tc
from ultravox_torch.models import decoder as tdec
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import mel as tmel
from ultravox_torch.ops.kernels import decode_attention as tda
from ultravox_torch.ops.kernels import segment_attention as tsa
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.ops import mel as jmel
from ultravox_tpu.ops.pallas import decode_attention as jda
from ultravox_tpu.ops.pallas import segment_attention as jsa

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = dict(rtol=1e-4, atol=1e-4)


def _tol(dt):
    return dict(rtol=0, atol=2e-5) if dt == "float32" else dict(rtol=2**-6, atol=2**-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's decode and segment kernels in interpret mode, where
    its decoder imports them (at trace time)."""
    monkeypatch.setattr(jda, "decode_attention", functools.partial(jda.decode_attention, interpret=True))
    monkeypatch.setattr(
        jsa, "segment_tail_attention", functools.partial(jsa.segment_tail_attention, interpret=True)
    )


# --------------------------------------------------------------------------
# kernels' plain versions against Pallas
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_matches_pallas(dt, window):
    """Ragged lengths from 1 to S, GQA group 2, with and without a window."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 4, 128, 4, 2, 64
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([1, 37, 100, S], np.int32)
    ref = jda.decode_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(lens), window,
        block_s=64, interpret=True,
    )
    before = tda.decode_attention.launches
    out = tda.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(lens), window
    )
    assert tda.decode_attention.launches == before  # a CPU tensor takes the plain version
    assert out.dtype == tdt and tuple(out.shape) == (B, H, D)
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


@pytest.mark.parametrize("window", [0, 6])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_segment_tail_attention_matches_pallas(dt, T, window):
    """T queries against layer 1 of a stacked 3-layer cache plus a tail,
    with prompt lengths 5..S and 0..5 tail slots written before."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(1)
    L, B, S, Hkv, G, D, Ts = 3, 3, 128, 2, 2, 64, 8
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    kc = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    tk = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    tv = rng.standard_normal((B, Ts, Hkv, D)).astype(np.float32)
    lens = np.array([5, 64, S], np.int32)
    written = np.array([0, 3, Ts - T], np.int32)
    ref = jsa.segment_tail_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, kc, vc)), jnp.asarray(1, jnp.int32),
        jnp.asarray(lens), *(jnp.asarray(a).astype(jdt) for a in (tk, tv)), jnp.asarray(written),
        window, block_s=64, interpret=True,
    )
    t = lambda a: torch.from_numpy(a).to(tdt)  # noqa: E731
    before = tsa.segment_tail_attention.launches
    out = tsa.segment_tail_attention(
        t(q), t(kc), t(vc), 1, torch.from_numpy(lens), t(tk), t(tv), torch.from_numpy(written),
        window,
    )
    assert tsa.segment_tail_attention.launches == before
    assert out.dtype == tdt and tuple(out.shape) == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), **_tol(dt))


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_attention_forms_match_jax(softcap):
    """ops.attention: mha with gemma-2's logit softcap, and the XLA-form
    decode_attention over a static cache with ragged valid lengths."""
    from ultravox_torch.ops import attention as tatt
    from ultravox_tpu.ops import attention as jatt

    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    lens = np.array([5, 24], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    np.testing.assert_allclose(
        tatt.mha(*t, scale=0.3, softcap=softcap).numpy(),
        np.asarray(jatt.mha(*j, scale=0.3, softcap=softcap)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tatt.decode_attention(*t, torch.from_numpy(lens)).numpy(),
        np.asarray(jatt.decode_attention(*j, jnp.asarray(lens))), rtol=1e-5, atol=1e-5)


def test_plain_versions_never_read_past_the_length():
    """Large finite garbage past each row's length (and past the written
    tail) changes nothing: those slots get probability exactly 0."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 64)).astype(np.float32))
    kc = torch.from_numpy(rng.standard_normal((2, 2, 32, 2, 64)).astype(np.float32))
    tk = torch.from_numpy(rng.standard_normal((2, 6, 2, 64)).astype(np.float32))
    lens, written = torch.tensor([9, 32], dtype=torch.int32), torch.tensor([1, 3], dtype=torch.int32)
    junk_kc, junk_tk = kc.clone(), tk.clone()
    junk_kc[:, 0, 9:] = 1e4
    junk_tk[0, 3:], junk_tk[1, 5:] = 1e4, 1e4
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # one fixed summation order on the CPU
    try:
        for a, b in ((kc, tk), (junk_kc, junk_tk)):
            dec = tda.decode_attention(q[:, 0], a[1], a[1], lens, 4)
            seg = tsa.segment_tail_attention(q, a, a, 1, lens, b, b, written, 5)
            if a is kc:
                ref_dec, ref_seg = dec, seg
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(dec, ref_dec) and torch.equal(seg, ref_seg)


# --------------------------------------------------------------------------
# decoder and engine paths against JAX
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def _jax_forward(cfg, **static):
    """The JAX decoder_forward, compiled once per call site (faster on the
    CPU than its op-by-op eager run)."""
    return jax.jit(functools.partial(jdec.decoder_forward, cfg=cfg, **static),
                   static_argnames=("return_hidden",))


def _prefill_both(jp, jd, tp, td, B=2, T=12, S=128, seed=3):
    """The same prompt prefilled into a cache by both packages (rows of T and
    T - 3 valid tokens). Returns (jax cache, torch cache, lengths)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, jd.vocab_size, (B, T)).astype(np.int32)
    lens = np.array([T, T - 3], np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    jcache = _jax_forward(jd)(
        jp, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos), kv_valid_len=jnp.asarray(lens),
        cache=jdec.KVCache.zeros(jd, B, S, jnp.float32), write_pos=jnp.zeros((B,), jnp.int32),
        return_hidden=True,
    )[1]
    tcache = tdec.decoder_forward(
        tp, td, input_ids=torch.from_numpy(ids), positions=torch.from_numpy(pos),
        kv_valid_len=torch.from_numpy(lens), cache=tdec.KVCache.zeros(td, B, S, torch.float32),
        write_pos=torch.zeros((B,), dtype=torch.int32), return_hidden=True,
    )[1]
    return jcache, tcache, lens


def _decode_step_both(jp, jd, tp, td, jcache, tcache, lens, tok):
    """One T=1 step at each row's length: (jax kernel, port kernel, port plain) logits."""
    def kw(a):
        return dict(input_ids=a(tok[:, None]), positions=a(lens[:, None]),
                    kv_valid_len=a(lens + 1), write_pos=a(lens))

    jl, _ = _jax_forward(jd, decode_kernel=True)(jp, cache=jcache, **kw(jnp.asarray))
    outs = []
    for kernel in (True, False):
        cache = tdec.KVCache(k=tcache.k.clone(), v=tcache.v.clone())
        outs.append(tdec.decoder_forward(
            tp, td, cache=cache, decode_kernel=kernel, **kw(torch.from_numpy))[0])
    return jl, outs[0], outs[1]


@pytest.mark.parametrize("window", [None, 5])
def test_decoder_decode_kernel_matches_jax(llama, pallas_interpret, window):
    """decode_kernel=True logits against the JAX decoder's kernel path and
    the port's plain path; ``window`` makes every layer mistral-local."""
    jcfg, tcfg, jparams, tparams = llama
    jd = dataclasses.replace(jcfg.text_config, sliding_window=window)
    td = dataclasses.replace(tcfg.text_config, sliding_window=window)
    jp, tp = jparams["language_model"], tparams["language_model"]
    jcache, tcache, lens = _prefill_both(jp, jd, tp, td)
    jl, tk, tx = _decode_step_both(jp, jd, tp, td, jcache, tcache, lens, np.array([7, 300], np.int32))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk.numpy(), tx.numpy(), **TOL)


def _greedy(logits):
    return logits.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("attn_impl", ["xla", "kernel"])
def test_segmented_decode_scan_matches_jax(llama, pallas_interpret, attn_impl):
    """Greedy tokens and the returned tail against the JAX scan."""
    jcfg, tcfg, jparams, tparams = llama
    jd, td = jcfg.text_config, tcfg.text_config
    jp, tp = jparams["language_model"], tparams["language_model"]
    jcache, tcache, lens = _prefill_both(jp, jd, tp, td)
    first = np.array([11, 200], np.int32)
    jt, jtail = jdec.segmented_decode_scan(
        jp, jd, jcache, jnp.asarray(lens), jnp.asarray(first), jax.random.key(0), n_steps=8,
        sample_fn=lambda lg, key: jnp.argmax(lg, -1).astype(jnp.int32), return_tail=True,
        attn_impl=attn_impl,
    )
    tt, ttail = tdec.segmented_decode_scan(
        tp, td, tcache, torch.from_numpy(lens), torch.from_numpy(first), n_steps=8,
        sample_fn=_greedy, return_tail=True, attn_impl=attn_impl,
    )
    assert tt.tolist() == np.asarray(jt).tolist()
    assert len(set(tt[0].tolist())) > 3, "degenerate tokens prove little"
    # tail k/v reach ~50 with the x8 weights, and a near-tied softmax in one
    # row moves with fp32 rounding: 1e-4 of the largest value (the port in
    # float64 agrees with JAX to 3e-5 there)
    for t, j in ((ttail.k, jtail.k), (ttail.v, jtail.v)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    # a page table needs the kernel (the XLA form takes a gathered view), as in JAX
    with pytest.raises(ValueError, match="attn_impl='kernel'"):
        tdec.segmented_decode_scan(
            tp, td, tcache, torch.from_numpy(lens), torch.from_numpy(first), n_steps=2,
            sample_fn=_greedy, attn_impl="xla", page_table=torch.zeros((2, 1), dtype=torch.int32),
        )


def test_engine_decode_paths_match_jax_from_raw_audio(llama, pallas_interpret):
    """generate(decode_attn_impl="kernel") and generate_fused give the JAX
    engine's greedy tokens (its kernel decode and its fused scan), each side
    computing its own log-mel from the same waveforms."""
    jcfg, tcfg, jparams, tparams = llama
    kw = dict(max_cache_len=128, encoder_attn_impl="fused", prefill_attn_impl="fused",
              decode_attn_impl="kernel")
    comp = jcfg.audio_token_compression
    jeng = JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    teng = tengine.GenerationEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    jb, tb = audio_batch(jmel.log_mel_spectrogram_np, comp), audio_batch(tmel.log_mel_spectrogram_np, comp)
    ref = jeng.generate(jb, max_new_tokens=12)
    assert jeng.generate_fused(jb, max_new_tokens=12).token_ids == ref.token_ids
    step = teng.generate(tb, max_new_tokens=12)
    fused = teng.generate_fused(tb, max_new_tokens=12)
    assert step.prompt_lens == fused.prompt_lens == [32, 28]
    assert step.token_ids == fused.token_ids == ref.token_ids
    assert all(len(set(row)) > 3 for row in step.token_ids), "degenerate tokens prove little"


def test_fused_sampling_equals_per_step_with_the_same_seed(llama):
    """Same-seed temperature/top-k sampling: generate and generate_fused draw
    in the same order and give the same tokens; greedy fused equals greedy."""
    _, tcfg, _, tparams = llama
    cfg = dataclasses.replace(tcfg, llm_only_training=True)
    eng = tengine.GenerationEngine(
        {"language_model": tparams["language_model"]}, cfg, max_cache_len=128,
        cache_dtype=torch.float32, device="cpu", stop_token_ids=(5,),
    )
    prompt = np.random.default_rng(4).integers(1, 512, (2, 9)).astype(np.int32)
    batch = {"input_ids": prompt, "attention_mask": np.ones_like(prompt)}
    samp = dict(max_new_tokens=16, temperature=0.8, top_k=20)
    step = eng.generate(batch, generator=torch.Generator().manual_seed(42), **samp)
    fused = eng.generate_fused(batch, generator=torch.Generator().manual_seed(42), **samp)
    other = eng.generate_fused(batch, generator=torch.Generator().manual_seed(7), **samp)
    assert step.token_ids == fused.token_ids != other.token_ids
    assert eng.generate_greedy_fused(batch, max_new_tokens=16).token_ids == \
        eng.generate(batch, max_new_tokens=16).token_ids


# --------------------------------------------------------------------------
# decoder families
# --------------------------------------------------------------------------

FAMILIES = {
    # gemma-2: attention softcap (the decode and segment kernels are not
    # taken), final softcap, plus-one norms, post-norms, alternating windows
    "gemma2": dict(
        arch="gemma2", hidden_size=48, num_layers=4, head_dim=12, sliding_window=16,
        sliding_window_pattern=2, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        query_pre_attn_scalar=12, scale_embeddings=True, use_post_norms=True,
        hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
    ),
    # gemma-3: qk-norm, local rope base, window 8 on every other layer
    "gemma3": dict(
        arch="gemma3", hidden_size=48, num_layers=3, head_dim=12, sliding_window=8,
        sliding_window_pattern=2, qk_norm=True, use_post_norms=True, scale_embeddings=True,
        final_logit_softcapping=30.0, rope_local_base_freq=10000.0, rope_theta=1000000.0,
        query_pre_attn_scalar=16, hidden_act="gelu_pytorch_tanh", tie_word_embeddings=True,
    ),
    # qwen-3: qk-norm (no plus-one), untied head
    "qwen3": dict(arch="qwen3", hidden_size=64, num_layers=3, head_dim=16, qk_norm=True),
}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    common = dict(vocab_size=384, intermediate_size=96, num_heads=4, num_kv_heads=2)
    jd = jc.DecoderConfig(**common, **FAMILIES[request.param])
    td = tc.DecoderConfig(**common, **FAMILIES[request.param])
    # the port's init_params builds the JAX package's tree, family leaves
    # included; the values are drawn here with numpy: norm weights around
    # their init of 1 and matrices 4x the init's 0.02 scale, so every leaf
    # matters and greedy tokens vary
    shapes = jax.eval_shape(lambda: jdec.init_params(jd, jax.random.key(5)))
    tree = tdec.init_params(td, torch.Generator().manual_seed(5))
    assert jax.tree.map(lambda a: tuple(a.shape), tree) == jax.tree.map(lambda a: a.shape, shapes)
    rng = np.random.default_rng(6)

    def draw(path, a):
        x = rng.standard_normal(tuple(a.shape)).astype(np.float32)
        name = path[-1].key
        return 1.0 + 0.2 * x if ("norm" in name or name.endswith("_ln")) else 0.08 * x

    np_tree = jax.tree_util.tree_map_with_path(draw, tree)
    jp = jax.tree.map(jnp.asarray, np_tree)
    tp = from_jax_params({"language_model": np_tree}, tc.UltravoxConfig(
        text_config=td, llm_only_training=True))["language_model"]
    return request.param, jd, td, jp, tp


def test_family_logits_match_jax(family, pallas_interpret):
    """Cache-less forward, prefill into a cache, then a decode step on the
    kernel and plain paths: logits to 1e-4."""
    name, jd, td, jp, tp = family
    rng = np.random.default_rng(8)
    B, T = 2, 20
    ids = rng.integers(1, jd.vocab_size, (B, T)).astype(np.int32)
    pos = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    lens = np.full((B,), T, np.int32)
    jl, _ = _jax_forward(jd)(jp, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
                             kv_valid_len=jnp.asarray(lens))
    tl, _ = tdec.decoder_forward(tp, td, input_ids=torch.from_numpy(ids), positions=torch.from_numpy(pos),
                                 kv_valid_len=torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jcache, tcache, lens = _prefill_both(jp, jd, tp, td, T=T)
    jl, tk, tx = _decode_step_both(jp, jd, tp, td, jcache, tcache, lens, np.array([3, 99], np.int32))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jl), **TOL)


def test_family_greedy_tokens_match_jax(family, pallas_interpret):
    """Greedy tokens of the port's per-step (decode kernel) and fused paths,
    and of the kernel segmented scan where the config has no attention
    softcap, equal the JAX engine's per-step tokens."""
    name, jd, td, jp, tp = family
    prompt = np.random.default_rng(9).integers(1, jd.vocab_size, (2, 11)).astype(np.int32)
    mask = np.ones_like(prompt)
    mask[1, 8:] = 0
    batch = {"input_ids": prompt, "attention_mask": mask}
    kw = dict(max_cache_len=128, decode_attn_impl="kernel")
    jeng = JEngine({"language_model": jp}, jc.UltravoxConfig(text_config=jd, llm_only_training=True),
                   cache_dtype=jnp.float32, **kw)
    ref = jeng.generate(batch, max_new_tokens=16).token_ids
    teng = tengine.GenerationEngine(
        {"language_model": tp}, tc.UltravoxConfig(text_config=td, llm_only_training=True),
        cache_dtype=torch.float32, device="cpu", **kw)
    assert teng.generate(batch, max_new_tokens=16).token_ids == ref
    assert teng.generate_fused(batch, max_new_tokens=16).token_ids == ref
    assert all(len(set(row)) > 3 for row in ref), "degenerate tokens prove little"
    if td.attn_logit_softcapping is None:
        tb = {k: torch.from_numpy(v) for k, v in teng.pad_batch(batch).items()}
        cache = teng._ensure_cache(None, 2, 128)
        logits, cache, lens = teng._prefill(tb, cache, 0)
        toks = tdec.segmented_decode_scan(
            teng.params["language_model"], td, cache, lens, _greedy(logits), n_steps=15,
            sample_fn=_greedy, attn_impl="kernel")
        assert [toks[0].tolist(), toks[1].tolist()] == ref
