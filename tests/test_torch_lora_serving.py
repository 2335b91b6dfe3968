"""Multi-LoRA serving in the port, against the JAX package, on the CPU.

The banks (build, fuse, gather) equal JAX's in fp32 within 1e-6;
``qkv_head_transpose``'s plain version equals the Pallas kernel (interpret
mode) bit for bit; the fused encoder on a banked-adapter tree equals JAX's
fused encoder within 2e-5 (fp32 summation order only; the adapters sharpen
the attention, which amplifies it from the base tree's 2e-6) and runs the
port's ``qkv_head_transpose``. Then the ServingEngine with two LM adapters beside
the base model (slots and paged modes), and with encoder adapters on the
fused encoder, gives exactly the greedy tokens of the JAX GenerationEngine
run per adapter on the unbanked trees; an unknown adapter finishes
"unknown_lora", prefix reuse is gated by the adapter, and encoder banks
that cannot apply raise at construction.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import drain, make_configs, make_params, serve, synth_audio
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import lora as tlora
from ultravox_torch.models import whisper_encoder as tenc
from ultravox_torch.models.config import LoraConfig as TLoraConfig
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import mel as tmel
from ultravox_torch.ops.kernels import fused_attention as tfa
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import whisper_encoder as jenc
from ultravox_tpu.models.config import LoraConfig
from ultravox_tpu.ops.pallas import fused_attention as jfa

MAX_NEW = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lora_tower(tower, targets, r, seed, scale, target_table):
    """``add_lora`` on one tower with a nonzero ``lora_b`` (normal * scale),
    so the adapter changes the output."""
    out = jlora.add_lora(tower, LoraConfig(r=r, target_modules=targets), jax.random.key(seed),
                         target_table)
    for tgt in targets:
        shp = out["layers"][tgt]["lora_b"].shape
        out["layers"][tgt]["lora_b"] = jax.random.normal(jax.random.key(seed + 50), shp) * scale
    return out


def _batch(rng, n_tokens, audio_seconds=None, compression=1):
    ids = rng.integers(1, 512, (1, n_tokens)).astype(np.int32)
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
    if audio_seconds is not None:
        mel = tmel.log_mel_spectrogram_np(synth_audio(audio_seconds, 5))
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
    """Configs, weights, LM adapters "a" and "b" (text LoRA r 4 on q/v/gate),
    encoder adapters "x" and "y" (audio LoRA r 2 on q/v, "y" also with text
    LoRA), as JAX trees and as port tensors. The encoder's lora_b is drawn
    at 0.1: larger adapters make attention logits that amplify fp32
    summation-order noise past 1e-4."""
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    from ultravox_tpu.models.lora import DECODER_TARGETS, ENCODER_TARGETS

    lm = {name: {"language_model": _lora_tower(jparams["language_model"],
                                               ("q_proj", "v_proj", "gate_proj"), 4, 10 + i,
                                               0.5, DECODER_TARGETS)}
          for i, name in enumerate(("a", "b"))}
    enc = {}
    for i, name in enumerate(("x", "y")):
        enc[name] = {"audio_tower": _lora_tower(jparams["audio_tower"], ("q_proj", "v_proj"), 2,
                                                30 + i, 0.1, ENCODER_TARGETS)}
    enc["y"]["language_model"] = _lora_tower(jparams["language_model"], ("q_proj", "v_proj"), 4,
                                             40, 0.5, DECODER_TARGETS)
    conv = lambda trees: {k: from_jax_params(_np(v), tcfg) for k, v in trees.items()}  # noqa: E731
    return jcfg, tcfg, jparams, tparams, lm, conv(lm), enc, conv(enc)


def _expected(jcfg, jparams, adapters, batches, names, **kw):
    """Greedy reference: the JAX GenerationEngine per adapter, on the base
    tree with the adapter's towers in place (unbanked LoRA)."""
    engines, out = {}, []
    for batch, name in zip(batches, names):
        if name not in engines:
            p = dict(jparams)
            if name is not None:
                p.update(adapters[name])
            engines[name] = JEngine(p, jcfg, max_cache_len=128, cache_dtype=jnp.float32, **kw)
        out.append(engines[name].generate(batch, max_new_tokens=MAX_NEW).token_ids[0])
    return out


def _engine(tparams, tcfg, **kw):
    base = dict(num_slots=4, max_seq_len=128, cache_dtype=torch.float32, device="cpu",
                prefill_len_buckets=(64, 128), mel_len_buckets=(400,), prefill_chunk_tokens=16,
                page_size=16, cache_mode="slots")
    base.update(kw)
    if base["cache_mode"] == "slots":
        base.pop("page_size")
    return tserve.ServingEngine(tparams, tcfg, **base)


def _jbanks(adapters, tower):
    return jlora.build_lora_banks({k: v[tower] for k, v in adapters.items()})


def _close(jtree, ttree, tol):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _close(jtree[k], ttree[k], tol)
    else:
        np.testing.assert_allclose(ttree.numpy(), np.asarray(jtree), rtol=tol, atol=tol)


def test_banks_match_jax(setup):
    """build_lora_banks, fuse_lora_banks (partial members: no k_proj or
    up_proj adapter) and apply_lora_banks (per-row and 0-dim index) equal
    JAX's, fp32 within 1e-6."""
    jcfg, tcfg, jparams, tparams, jlm, tlm, jenc_ad, tenc_ad = setup
    tc = tcfg.text_config
    jb, jidx = _jbanks(jlm, "language_model")
    tb, tidx = tlora.build_lora_banks({k: v["language_model"] for k, v in tlm.items()})
    assert tidx == jidx == {"a": 1, "b": 2}
    _close(jb, tb, 1e-6)
    assert float(tb["q_proj"]["a"][:, 0].abs().max()) == 0.0  # slot 0: the base model
    kv = tc.num_kv_heads * tc.head_dim
    dims = dict(qkv_dims=(tc.num_heads * tc.head_dim, kv, kv),
                gateup_dims=(tc.intermediate_size, tc.intermediate_size))
    jf, tf = jlora.fuse_lora_banks(jb, **dims), tlora.fuse_lora_banks(tb, **dims)
    _close(jf, tf, 1e-6)
    idx = np.array([0, 2, 1], np.int32)
    _close(jlora.apply_lora_banks({"layers": {k: {} for k in jf}}, jf, jnp.asarray(idx)),
           tlora.apply_lora_banks({"layers": {k: {} for k in tf}}, tf, torch.from_numpy(idx)), 1e-6)
    # the encoder-only fuse (gateup_dims=()), gathered for one request
    D = jcfg.audio_config.d_model
    je, _ = _jbanks(jenc_ad, "audio_tower")
    te, _ = tlora.build_lora_banks({k: v["audio_tower"] for k, v in tenc_ad.items()})
    je, te = (m.fuse_lora_banks(b, qkv_dims=(D, D, D), gateup_dims=()) for m, b in
              ((jlora, je), (tlora, te)))
    assert set(te) == {"qkv_proj"}
    _close(je, te, 1e-6)
    _close(jlora.apply_lora_banks({"layers": {"qkv_proj": {}}}, je, jnp.asarray(2, jnp.int32)),
           tlora.apply_lora_banks({"layers": {"qkv_proj": {}}}, te, torch.tensor(2)), 1e-6)


def test_banks_with_mismatched_ranks_raise():
    def tree(r):
        return {"layers": {"q_proj": {"lora_a": torch.zeros((2, 8, r)),
                                      "lora_b": torch.zeros((2, r, 8)),
                                      "lora_scale": torch.ones((2,))}}}

    with pytest.raises(ValueError, match="matching ranks"):
        tlora.build_lora_banks({"a": tree(4), "b": tree(2)})
    with pytest.raises(ValueError, match="no lora_a"):
        tlora.build_lora_banks({"a": {"layers": {"q_proj": {"kernel": torch.zeros((2, 8, 8))}}}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 128, 6, 16), (1, 256, 12, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_qkv_head_transpose_plain_matches_pallas(shape, dtype):
    B, T, G, Dh = shape
    x = np.random.default_rng(0).standard_normal((B, T, G * Dh)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jfa.qkv_head_transpose(jx, Dh, interpret=True).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = tfa.qkv_head_transpose(tx, Dh)
    assert out.shape == (B, G, T, Dh) and out.dtype == tx.dtype
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_fused_encoder_with_banked_adapters_matches_jax(setup, monkeypatch):
    """The fused encoder on a fused tree with a banked encoder adapter
    gathered for one request (the serving engine's admission), against the
    JAX fused encoder on the same tree: fp32 within 2e-5. Each layer runs
    the port's qkv_head_transpose once."""
    jcfg, tcfg, jparams, tparams, _, _, jenc_ad, tenc_ad = setup
    ac, D = jcfg.audio_config, jcfg.audio_config.d_model
    je, jidx = _jbanks(jenc_ad, "audio_tower")
    te, _ = tlora.build_lora_banks({k: v["audio_tower"] for k, v in tenc_ad.items()})
    je = jlora.fuse_lora_banks(je, qkv_dims=(D, D, D), gateup_dims=())
    te = tlora.fuse_lora_banks(te, qkv_dims=(D, D, D), gateup_dims=())
    jt = jenc.fuse_encoder_inference_params(jparams["audio_tower"])
    tt = tenc.fuse_encoder_inference_params(tparams["audio_tower"])
    mel = tmel.log_mel_spectrogram_np(synth_audio(1.5, 2))[None]
    lens = np.array([mel.shape[-1]], np.int32)
    calls = []
    orig = tenc.qkv_head_transpose
    monkeypatch.setattr(tenc, "qkv_head_transpose", lambda *a: calls.append(1) or orig(*a))
    for name in ("x", "y"):
        i = jidx[name]
        ref = jenc.encoder_forward(jlora.apply_lora_banks(jt, je, jnp.asarray(i, jnp.int32)), ac,
                                   jnp.asarray(mel), jnp.asarray(lens), attn_impl="fused")
        out = tenc.encoder_forward(tlora.apply_lora_banks(tt, te, torch.tensor(i)), tcfg.audio_config,
                                   torch.from_numpy(mel), torch.from_numpy(lens), attn_impl="fused")
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert len(calls) == 2 * ac.num_layers


@pytest.fixture(scope="module")
def lm_expected(setup):
    """Requests on the base model and on adapters "a" and "b" (one prompt
    under three adapters, then a shorter one), with the JAX engine's greedy
    tokens per adapter; one reference for both cache modes."""
    jcfg, _, jparams, _, jlm, _, _, _ = setup
    rng = np.random.default_rng(1)
    batches = [_batch(rng, 20), _batch(rng, 20), _batch(rng, 20), _batch(rng, 11)]
    batches[1] = batches[2] = batches[0]
    names = [None, "a", "b", "b"]
    expected = _expected(jcfg, jparams, jlm, batches, names)
    assert len({tuple(e) for e in expected[:3]}) == 3, "the adapters must change the tokens"
    return batches, names, expected


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_multi_lora_serving_matches_jax_per_adapter(setup, lm_expected, mode):
    """Requests on the base model and on adapters "a" and "b" in one engine,
    through single steps and 4-step blocks, give the JAX engine's greedy
    tokens per adapter."""
    _, tcfg, _, tparams, _, tlm, _, _ = setup
    batches, names, expected = lm_expected
    eng = _engine(tparams, tcfg, cache_mode=mode, decode_block_steps=4, lora_adapters=tlm)
    out = serve(eng, batches, names, MAX_NEW)
    assert [ids for ids, _ in out] == expected
    assert [f for _, f in out] == ["length"] * 4
    assert eng.stat_decode_steps > eng.stat_decode_dispatches  # blocks ran


def test_encoder_adapters_on_the_fused_encoder_match_jax(setup):
    """Audio requests on the base model and on encoder adapters "x" and "y"
    ("y" also carries text LoRA) with encoder_attn_impl="fused": the JAX
    engine's greedy tokens per adapter, with the JAX fused encoder."""
    jcfg, tcfg, jparams, tparams, _, _, jenc_ad, tenc_ad = setup
    comp = jcfg.audio_token_compression
    batch = _batch(np.random.default_rng(2), 24, 1.5, comp)
    names = [None, "x", "y"]
    expected = _expected(jcfg, jparams, jenc_ad, [batch] * 3, names, encoder_attn_impl="fused")
    assert len({tuple(e) for e in expected}) == 3, "the adapters must change the tokens"
    eng = _engine(tparams, tcfg, encoder_attn_impl="fused", lora_adapters=tenc_ad)
    assert eng._lora_banks is not None and set(eng._enc_lora_banks) == {"qkv_proj"}
    out = serve(eng, [batch] * 3, names, MAX_NEW)
    assert out == [(e, "length") for e in expected]


def test_unknown_adapter_and_prefix_reuse_gated_by_adapter(setup):
    """An adapter the engine does not hold finishes "unknown_lora"; a
    retained prefix is reused only by a request on the same adapter."""
    _, tcfg, _, tparams, _, tlm, _, _ = setup
    batch = _batch(np.random.default_rng(3), 30)
    eng = _engine(tparams, tcfg, num_slots=1, lora_adapters=tlm)
    eng.start()
    try:
        assert drain(eng, eng.submit(dict(batch), max_tokens=4, lora="zzz")) == ([], "unknown_lora")
        drain(eng, eng.submit(dict(batch), max_tokens=4, lora="a"))
        drain(eng, eng.submit(dict(batch), max_tokens=4, lora="b"))
        assert eng.reused_prefix_tokens == 0
        drain(eng, eng.submit(dict(batch), max_tokens=4, lora="b"))
        assert eng.reused_prefix_tokens > 0
    finally:
        eng.stop()


def test_encoder_banks_validated_at_construction(setup):
    """Encoder banks that cannot apply to the served tower raise at
    construction: no tower, a missing target, mismatched dims."""
    _, tcfg, _, tparams, _, _, _, tenc_ad = setup
    kw = dict(num_slots=1, max_seq_len=64, cache_dtype=torch.float32, device="cpu",
              prefill_len_buckets=(64,), mel_len_buckets=(400,), cache_mode="slots",
              lora_adapters=tenc_ad)
    with pytest.raises(ValueError, match="no audio tower"):
        tserve.ServingEngine({k: v for k, v in tparams.items() if k != "audio_tower"}, tcfg, **kw)
    tower = dict(tparams["audio_tower"])
    layers = dict(tower["layers"])
    layers.pop("v_proj")
    with pytest.raises(ValueError, match="v_proj"):
        tserve.ServingEngine(dict(tparams, audio_tower=dict(tower, layers=layers)), tcfg, **kw)
    layers = dict(tparams["audio_tower"]["layers"])
    layers["q_proj"] = dict(layers["q_proj"], kernel=torch.zeros((2, 64, 128)))
    with pytest.raises(ValueError, match="q_proj"):
        tserve.ServingEngine(dict(tparams, audio_tower=dict(tower, layers=layers)), tcfg, **kw)
    tserve.ServingEngine(tparams, tcfg, **kw)  # the matching tower constructs


def test_port_add_lora_trees_bank_and_serve(setup):
    """Adapters made by the port's own add_lora (zero lora_b: the identity)
    bank and serve the base model's tokens."""
    _, tcfg, _, tparams, _, _, _, _ = setup
    g = torch.Generator().manual_seed(0)
    ad = {"p": {"language_model": tlora.add_lora(
        tparams["language_model"], TLoraConfig(r=2, target_modules=("q_proj",)), g,
        tlora.DECODER_TARGETS)}}
    batch = _batch(np.random.default_rng(4), 16)
    base = serve(_engine(tparams, tcfg), [batch], [None], MAX_NEW)
    assert serve(_engine(tparams, tcfg, lora_adapters=ad), [batch], ["p"], MAX_NEW) == base
