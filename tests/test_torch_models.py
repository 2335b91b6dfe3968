"""The port's model modules against the JAX package's, on the CPU.

Same numpy inputs and parameters on both sides. fp32 throughout, with JAX at
``highest`` matmul precision (tests/conftest.py) and torch's fp32 matmuls
(no TF32 on the CPU). Tolerance 1e-4 absolute and relative: the two sum in
different orders through several layers.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import audio_batch, make_configs, make_params, synth_audio
from ultravox_torch.models import decoder as tdec
from ultravox_torch.models import projector as tproj
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.models import whisper_encoder as tenc
from ultravox_torch.models.config import UltravoxConfig as TUltravoxConfig
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import mel as tmel
from ultravox_torch.ops import norms as tnorms
from ultravox_torch.ops import rope as trope
from ultravox_torch.ops.sampling import sample_token
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.models import projector as jproj
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.models import weights as jweights
from ultravox_tpu.models import whisper_encoder as jenc
from ultravox_tpu.models.config import UltravoxConfig as JUltravoxConfig
from ultravox_tpu.ops import mel as jmel
from ultravox_tpu.ops import norms as jnorms
from ultravox_tpu.ops import rope as jrope

TOL = dict(rtol=1e-4, atol=1e-4)
FIXTURE = os.path.join(os.path.dirname(__file__), "assets", "tiny_ultravox")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_jax_params_round_trip(dtype):
    """The tiny checkpoint fixture converted by the JAX package arrives in
    the port with the same keys, shapes and bits (stacked layers included)."""
    jcfg = JUltravoxConfig.from_pretrained_dir(FIXTURE)
    tcfg = TUltravoxConfig.from_pretrained_dir(FIXTURE)
    sd = jweights.load_safetensors_dir(FIXTURE)
    jparams = jweights.convert_ultravox(sd, jcfg, dtype)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)
    jflat, tflat = _flat(jparams), _flat(tparams)
    assert sorted(jflat) == sorted(tflat)
    assert any("/layers/" in k for k in tflat)
    for k, ja in jflat.items():
        ta = tflat[k]
        assert tuple(ta.shape) == tuple(ja.shape), k
        np.testing.assert_array_equal(ta.float().numpy(), np.asarray(ja.astype(jnp.float32)), err_msg=k)


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(w)).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    scaling = (32.0, 1.0, 4.0, 8192)
    inv = trope.rope_frequencies(64, 500000.0, scaling)
    np.testing.assert_array_equal(inv, jrope.rope_frequencies(64, 500000.0, scaling))
    pos = np.array([[0, 3, 17, 900, 5000]], np.int32).repeat(2, 0)
    tc, ts = trope.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    np.testing.assert_allclose(
        trope.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)


def test_mel_matches_jax():
    """The port's host mel is the JAX package's bit for bit; its device
    (torch rFFT, fp32) version agrees to 1e-4."""
    wav = synth_audio(1.3, 0)
    host = tmel.log_mel_spectrogram_np(wav)
    np.testing.assert_array_equal(host, jmel.log_mel_spectrogram_np(wav))
    dev = tmel.log_mel_spectrogram(torch.from_numpy(np.stack([wav, wav[::-1].copy()])))
    assert dev.shape == (2, 80, len(wav) // 160)
    np.testing.assert_allclose(dev[0].numpy(), host, atol=1e-4)
    np.testing.assert_allclose(dev[1].numpy(), tmel.log_mel_spectrogram_np(wav[::-1]), atol=1e-4)


@pytest.mark.parametrize("latency_block", [None, 8])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_encoder_matches_jax(setup, impl, latency_block):
    """Each encoder path against the same JAX path: plain (erf GELU, bias
    masks) and fused (tanh GELU, kernels; JAX pads T to 128, the port not)."""
    jcfg, tcfg, jparams, tparams = setup
    b = audio_batch(jmel.log_mel_spectrogram_np, jcfg.audio_token_compression)
    jp, tp = jparams["audio_tower"], tparams["audio_tower"]
    if impl == "fused":
        jp = jenc.fuse_encoder_inference_params(jp)
        tp = tenc.fuse_encoder_inference_params(tp)
    ref = jenc.encoder_forward(
        jp, jcfg.audio_config, jnp.asarray(b["audio_values"]), jnp.asarray(b["audio_lens"]),
        latency_block_size=latency_block, attn_impl=impl,
    )
    out = tenc.encoder_forward(
        tp, tcfg.audio_config, torch.from_numpy(b["audio_values"]),
        torch.from_numpy(b["audio_lens"]), latency_block_size=latency_block, attn_impl=impl,
    )
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fused_encoder_tree_keeps_layer_norms_in_fp32(setup):
    """The fused tree holds the layers' LayerNorm parameters in fp32 (what
    the kernels read) and q/k/v as one product; a bf16 encoder gives the
    same output from it as from the unfused tree's bf16 LayerNorms."""
    jcfg, tcfg, _, tparams = setup

    def bf16(tree):
        return {k: bf16(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.bfloat16()

    bf = bf16(tparams["audio_tower"])
    fused = tenc.fuse_encoder_inference_params(bf)
    for n in ("attn_ln", "final_ln"):
        for k in ("scale", "bias"):
            assert fused["layers"][n][k].dtype == torch.float32
            assert torch.equal(fused["layers"][n][k], bf["layers"][n][k].float())
    assert fused["layers"]["qkv_proj"]["kernel"].dtype == torch.bfloat16
    assert "q_proj" not in fused["layers"]
    b = audio_batch(jmel.log_mel_spectrogram_np, jcfg.audio_token_compression)
    mel = torch.from_numpy(b["audio_values"]).to(torch.bfloat16)
    lens = torch.from_numpy(b["audio_lens"])
    out = tenc.encoder_forward(fused, tcfg.audio_config, mel, lens, attn_impl="fused")
    unfused_ln = dict(fused, layers={**fused["layers"], **{
        n: bf["layers"][n] for n in ("attn_ln", "final_ln")}})
    ref = tenc.encoder_forward(unfused_ln, tcfg.audio_config, mel, lens, attn_impl="fused")
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref)


def test_cache_write_drops_positions_past_the_end(setup):
    """k/v land at write_pos + t; a position past the cache's end drops."""
    _, tcfg, _, _ = setup
    dcfg = tcfg.text_config
    cache = tdec.KVCache.zeros(dcfg, 2, 8, torch.float32)
    shape = (2, 4, dcfg.num_kv_heads, dcfg.head_dim)
    k = torch.arange(np.prod(shape), dtype=torch.float32).reshape(shape) + 1
    write_pos = torch.tensor([5, 0])
    tdec._write_cache(cache, 1, k, -k, tdec._cache_slots(cache, write_pos, 4))
    assert torch.equal(cache.k[1, 0, 5:], k[0, :3])
    assert torch.equal(cache.k[1, 1, :4], k[1])
    assert torch.equal(cache.v[1, 1, :4], -k[1])
    assert not cache.k[1, 0, :5].any() and not cache.k[1, 1, 4:].any()
    assert not cache.k[0].any()


def test_projector_and_splice_match_jax(setup):
    jcfg, tcfg, jparams, tparams = setup
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 75, 128)).astype(np.float32)
    ref = jproj.projector_forward(jparams["projector"], jcfg, jnp.asarray(enc))
    out = tproj.projector_forward(tparams["projector"], tcfg, torch.from_numpy(enc))
    assert tuple(out.shape) == ref.shape == (2, 10, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tproj.num_audio_tokens(150, tcfg.audio_token_compression) == 10
    emb = rng.standard_normal((2, 32, 128)).astype(np.float32)
    idx = [np.array(a, np.int32) for a in ([4, 20], [10, 3], [0, 1])]  # start, len, row
    ref = juv.splice_audio_embeds(jnp.asarray(emb), ref, *(jnp.asarray(a) for a in idx))
    out = tuv.splice_audio_embeds(torch.from_numpy(emb), out, *(torch.from_numpy(a) for a in idx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("prefill_kernel,window", [(False, None), (True, None), (False, 10)])
def test_decoder_prefill_then_decode_matches_jax(setup, prefill_kernel, window):
    """Prefill into a cache at a nonzero offset, then one T=1 decode step:
    logits and the written cache rows agree. ``window`` runs mistral-style
    sliding-window attention, where the prefill kernel is not taken."""
    jcfg, tcfg, jparams, tparams = setup
    jcfg = dataclasses.replace(
        jcfg, text_config=dataclasses.replace(jcfg.text_config, sliding_window=window))
    tcfg = dataclasses.replace(
        tcfg, text_config=dataclasses.replace(tcfg.text_config, sliding_window=window))
    jp = jdec.fuse_inference_params(jparams["language_model"], jcfg.text_config)
    tp = tdec.fuse_inference_params(tparams["language_model"], tcfg.text_config)
    rng = np.random.default_rng(5)
    B, T, S, start = 2, 16, 64, 3
    ids = rng.integers(1, 512, (B, T)).astype(np.int32)
    lens = np.array([start + T, start + 11], np.int32)
    pos = start + np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    wpos = np.full((B,), start, np.int32)
    jcache = jdec.KVCache.zeros(jcfg.text_config, B, S, jnp.float32)
    tcache = tdec.KVCache.zeros(tcfg.text_config, B, S, torch.float32)
    jl, jcache = jdec.decoder_forward(
        jp, jcfg.text_config, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
        kv_valid_len=jnp.asarray(lens), cache=jcache, write_pos=jnp.asarray(wpos),
        prefill_kernel=prefill_kernel,
    )
    tl, tcache = tdec.decoder_forward(
        tp, tcfg.text_config, input_ids=torch.from_numpy(ids), positions=torch.from_numpy(pos),
        kv_valid_len=torch.from_numpy(lens), cache=tcache, write_pos=torch.from_numpy(wpos),
        prefill_kernel=prefill_kernel,
    )
    for b in range(B):
        n = lens[b] - start
        np.testing.assert_allclose(tl[b, :n].numpy(), np.asarray(jl[b, :n]), **TOL)
        np.testing.assert_allclose(
            tcache.k[:, b, : lens[b]].numpy(), np.asarray(jcache.k[:, b, : lens[b]]), **TOL)
    tok = np.array([7, 300], np.int32)
    jl, jcache = jdec.decoder_forward(
        jp, jcfg.text_config, input_ids=jnp.asarray(tok[:, None]),
        positions=jnp.asarray(lens[:, None]), kv_valid_len=jnp.asarray(lens + 1),
        cache=jcache, write_pos=jnp.asarray(lens),
    )
    tl, tcache = tdec.decoder_forward(
        tp, tcfg.text_config, input_ids=torch.from_numpy(tok[:, None]),
        positions=torch.from_numpy(lens[:, None]), kv_valid_len=torch.from_numpy(lens + 1),
        cache=tcache, write_pos=torch.from_numpy(lens),
    )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(
        tdec.compute_logits(tp, tcfg.text_config, torch.ones(2, 128)).numpy(),
        np.asarray(jdec.compute_logits(jp, jcfg.text_config, jnp.ones((2, 128)))), **TOL)


def test_sampling_greedy_and_filters():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    want = np.argmax(logits, -1)
    t = torch.from_numpy(logits)
    g = torch.Generator().manual_seed(0)
    assert sample_token(t).numpy().tolist() == want.tolist()
    # a filter that keeps only the top token makes sampling greedy
    for kw in (dict(top_k=1), dict(top_p=1e-6), dict(min_p=0.999)):
        got = sample_token(t, g, temperature=0.7, **kw)
        assert got.dtype == torch.int32 and got.numpy().tolist() == want.tolist(), kw
    draws = torch.stack([sample_token(t, g, temperature=1.0, top_k=5) for _ in range(64)])
    top5 = np.argsort(-logits, -1)[:, :5]
    assert all(int(d) in top5[i] for row in draws for i, d in enumerate(row))
