"""The port's streaming encode on the CPU, against the JAX package.

On the encoder of tests/test_streaming_encoder.py (d 32, 2 layers, 64
positions, latency blocks of C = 8) and its streaming model's decoder, with
weights from a seed carried across by ``from_jax_params`` (fp32, matmuls
at "highest" precision, set by tests/conftest.py):

- ``encoder_stream_step``: every block's output and the K/V state within
  1e-5 of JAX's, over four whole blocks and a partial one, on the unfused
  q/k/v tower and the inference-fused ``qkv_proj`` one; ``_conv1d_valid``
  against JAX's in fp32 and bf16;
- ``StreamingMel``: frames bit-equal to JAX's, fed in irregular chunks;
- ``StreamingAudioEncoder``: ``finalize`` within 1e-5 of JAX's and within
  3e-5 of the port's own batch block-causal encode plus projector (the
  tolerance tests/test_streaming_encoder.py gives the JAX pair); the
  overflow block raises ``EncoderWindowExceeded`` at the same block; the
  empty stream has shape (0, d_text); a call from a fresh thread records
  no autograd graph;
- the streamed embeddings, submitted to the port's ServingEngine, give the
  greedy tokens the JAX ServingEngine gives for JAX's streamed embeddings.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.inference import streaming as tstream
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import config as tc
from ultravox_torch.models import processor as tproc
from ultravox_torch.models import projector as tproj
from ultravox_torch.models import whisper_encoder as tenc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import mel as tmel
from ultravox_tpu.inference import streaming as jstream
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import processor as jproc
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.models import whisper_encoder as jenc

C = 8  # the latency block, in encoder positions
TOL = 1e-5


def _cfg(c):
    return c.UltravoxConfig(
        audio_config=c.WhisperEncoderConfig(
            d_model=32, num_layers=2, num_heads=2, ffn_dim=64, max_source_positions=64),
        text_config=c.DecoderConfig(
            vocab_size=384, hidden_size=48, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12),
        hidden_size=64,
        audio_latency_block_size=C,
    )


@pytest.fixture(scope="module")
def model():
    """(JAX config, port config, JAX params, port params). The projector and
    decoder matrices are scaled up from the 0.02 init, so greedy tokens move
    from step to step and a wrong embedding shows as other tokens."""
    jcfg, tcfg = _cfg(jc), _cfg(tc)
    params = juv.init_params(jcfg, jax.random.key(3))
    scale = {"audio_tower": 1.0, "projector": 8.0, "language_model": 8.0}
    params = {k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
              for k, v in params.items()}
    return jcfg, tcfg, params, from_jax_params(jax.tree.map(np.asarray, params), tcfg)


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    audio[: n // 10] *= 4.0  # an early peak: the running mel clamp equals the batch one
    return audio


def _window(mel, k):
    """Mel window [2kC-2, 2(k+1)C+1), zero outside the stream."""
    lo, hi = k * 2 * C - 2, (k + 1) * 2 * C + 1
    w = np.zeros((mel.shape[0], hi - lo), np.float32)
    s, e = max(lo, 0), min(hi, mel.shape[1])
    w[:, s - lo: e - lo] = mel[:, s:e]
    return w


@pytest.mark.parametrize("layout", ["unfused", "fused"])
def test_stream_step_matches_jax(model, layout):
    jcfg, tcfg, jp, tp = model
    jt, tt = jp["audio_tower"], tp["audio_tower"]
    if layout == "fused":
        jt, tt = jenc.fuse_encoder_inference_params(jt), tenc.fuse_encoder_inference_params(tt)
        assert "qkv_proj" in tt["layers"] and "q_proj" not in tt["layers"]
    mel = np.random.default_rng(0).standard_normal((80, 70)).astype(np.float32)
    feat_len = (70 - 1) // 2 + 1  # 35: four whole blocks of 8 and one of 3
    jstate = jenc.EncoderStreamState.zeros(jcfg.audio_config)
    tstate = tenc.EncoderStreamState.zeros(tcfg.audio_config)
    for k in range(5):
        n_valid = int(np.clip(feat_len - k * C, 0, C))
        jstate, jout = jenc.encoder_stream_step(
            jt, jstate, jnp.asarray(_window(mel, k)), jnp.asarray(n_valid, jnp.int32),
            cfg=jcfg.audio_config, block_size=C)
        tstate, tout = tenc.encoder_stream_step(
            tt, tstate, torch.from_numpy(_window(mel, k)), n_valid,
            cfg=tcfg.audio_config, block_size=C)
        assert tout.shape == (C, 32)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
        assert tstate.pos == int(jstate.pos) == min(feat_len, (k + 1) * C)
        np.testing.assert_allclose(tstate.k.numpy(), np.asarray(jstate.k), atol=TOL, rtol=0)
        np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1d_valid_matches_jax(dtype):
    """Cast to the kernel's dtype, the product accumulated in fp32, the
    bias, the cast back: JAX upcasts bf16 patches on XLA's CPU, the port
    always multiplies in fp32. Equal within fp32 summation order, then one
    rounding to the output dtype (an ulp of bf16 at most)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 80, 19)).astype(np.float32)
    w = (rng.standard_normal((3, 80, 32)) * 0.1).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for stride in (1, 2):
        want = np.asarray(jenc._conv1d_valid(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                             jnp.asarray(b, jdt), stride).astype(jnp.float32))
        got = tenc._conv1d_valid(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                 torch.from_numpy(b).to(tdt), stride)
        assert got.dtype == tdt
        got = got.float().numpy().transpose(0, 2, 1)
        tol = TOL if dtype == "float32" else 2.0**-8 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_streaming_mel_matches_jax():
    audio = _audio(24000, 2)
    jm, tm = jstream.StreamingMel(80), tstream.StreamingMel(80)
    sizes = [1, 159, 160, 4096, 1, 399, 400, 401, 1365, 2, 7000]
    i, got, want = 0, [], []
    for n in sizes + [len(audio)]:
        a, b = jm.feed(audio[i: i + n]), tm.feed(audio[i: i + n])
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
            want.append(a)
            got.append(b)
        i += n
    a, b = jm.finalize(), tm.finalize()
    np.testing.assert_array_equal(b, a)
    assert tm.frames_emitted == jm.frames_emitted == len(audio) // tmel.HOP_LENGTH
    # and the whole equals the batch front end's (the peak came first)
    np.testing.assert_allclose(np.concatenate(got + [b], axis=1),
                               tmel.log_mel_spectrogram_np(audio, 80), atol=1e-5, rtol=1e-5)


def _stream(enc, audio, chunk):
    for i in range(0, len(audio), chunk):
        enc.feed(audio[i: i + chunk])
    return enc.finalize()


def test_streaming_encoder_matches_jax_and_batch(model):
    jcfg, tcfg, jp, tp = model
    audio = _audio(9600, 3)
    want = _stream(jstream.StreamingAudioEncoder(jp, jcfg), audio, 800)
    enc = tstream.StreamingAudioEncoder(tp, tcfg)
    got = _stream(enc, audio, 800)
    n_tokens = -(-(len(audio) // 160) // 16)
    assert got.shape == want.shape == (n_tokens, 48)
    assert enc.blocks_encoded == 4
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)

    # the port's own batch block-causal encode of the clip, plus projector
    mel = tmel.log_mel_spectrogram_np(audio, 80)
    pad = np.zeros((1, 80, 80), np.float32)
    pad[0, :, : mel.shape[1]] = mel
    with torch.inference_mode():
        full = tenc.encoder_forward(tp["audio_tower"], tcfg.audio_config, torch.from_numpy(pad),
                                    torch.tensor([mel.shape[1]]), latency_block_size=C)
        batch = tproj.projector_forward(tp["projector"], tcfg, full)[0, :n_tokens]
    np.testing.assert_allclose(got.numpy(), batch.numpy(), atol=3e-5, rtol=3e-5)


def test_window_overflow_raises_at_the_same_block(model):
    """64 positions are 1.28 s: a 3 s stream raises on the block that would
    pass the window, in the same feed call as the JAX class."""
    jcfg, tcfg, jp, tp = model
    audio = _audio(48000, 4)
    raised = []
    for enc, exc in ((jstream.StreamingAudioEncoder(jp, jcfg), jstream.EncoderWindowExceeded),
                     (tstream.StreamingAudioEncoder(tp, tcfg), tstream.EncoderWindowExceeded)):
        with pytest.raises(exc) as info:
            for i in range(0, len(audio), 3000):
                enc.feed(audio[i: i + 3000])
                raised_at = i
            enc.finalize()
        assert "encoder window" in str(info.value)
        raised.append((raised_at, enc.blocks_encoded))
    assert raised[0] == raised[1]
    assert raised[1][1] == 64 // C


def test_empty_stream_has_no_tokens(model):
    _, tcfg, _, tp = model
    enc = tstream.StreamingAudioEncoder(tp, tcfg)
    enc.feed(np.zeros(100, np.float32))  # under one hop
    out = enc.finalize()
    assert out.shape == (0, tcfg.text_config.hidden_size)


def test_stream_from_a_fresh_thread_records_no_graph(model):
    """Autograd's mode is per thread: a server's handler thread does not
    inherit the engine loop's. Even with weights that require grad, the
    stream's state and outputs carry no graph."""
    _, tcfg, _, tp = model
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    out = {}

    def run():
        enc = tstream.StreamingAudioEncoder(params, tcfg)
        enc.feed(_audio(9600, 5))
        out["block"] = enc._outputs[0]
        out["state"] = enc.state
        out["embeds"] = enc.finalize()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    for tensor in (out["block"], out["state"].k, out["state"].v, out["embeds"]):
        assert not tensor.requires_grad and tensor.grad_fn is None
        assert torch.is_inference(tensor)


def _streamed_request(processor, collator, embeds, text):
    feats = processor(text=text, audio_token_lens=[embeds.shape[0]])
    batch = collator([{"input_ids": feats["input_ids"]}])
    for key in ("audio_token_len", "audio_token_start_idx", "audio_chunk_batch_idx"):
        batch[key] = feats[key]
    spans = ((int(feats["audio_token_start_idx"][0]), int(feats["audio_token_len"][0]), "s"),)
    return batch, spans


def _tokens(engine, batch, embeds, spans):
    engine.start()
    try:
        req = engine.submit(batch, max_tokens=10, audio_embeds=embeds, audio_spans=spans)
        return [ev.token_id for ev in engine.stream(req, timeout=300) if ev.token_id is not None]
    finally:
        engine.stop()


def test_streamed_embeds_serve_like_jax(model):
    jcfg, tcfg, jp, tp = model
    tok = make_tiny_tokenizer()
    audio, text = _audio(9600, 6), "transcribe <|audio|> please"
    kw = dict(num_slots=2, max_seq_len=128, prefill_len_buckets=(64, 128), mel_len_buckets=(80,))
    jemb = _stream(jstream.StreamingAudioEncoder(jp, jcfg), audio, 1365)
    temb = _stream(tstream.StreamingAudioEncoder(tp, tcfg), audio, 1365)
    np.testing.assert_allclose(temb.numpy(), jemb, atol=TOL, rtol=0)
    jb, spans = _streamed_request(jproc.UltravoxProcessor(tok),
                                  jproc.DataCollatorWithAudio(pad_token_id=tok.pad_token_id,
                                                              pad_multiple=1), jemb, text)
    tb, tspans = _streamed_request(tproc.UltravoxProcessor(tok),
                                   tproc.DataCollatorWithAudio(pad_token_id=tok.pad_token_id,
                                                               pad_multiple=1), temb, text)
    assert spans == tspans and all(np.array_equal(jb[k], tb[k]) for k in jb)
    want = _tokens(jserve.ServingEngine(jp, jcfg, cache_dtype=jnp.float32, **kw), jb,
                   jemb[None], spans)
    got = _tokens(tserve.ServingEngine(tp, tcfg, cache_dtype=torch.float32, device="cpu", **kw),
                  tb, temb[None], tspans)
    assert len(want) == 10 and len(set(want)) > 1
    assert got == want
