"""The port's voice path on the CPU, against the JAX package: the VAD, the
WebSocket codec and the ``/ws/voice`` conversation loop.

- ``ReplyOnPause`` gives the JAX class's utterances bit for bit on the
  synthetic streams of tests/test_voice_demo.py; ``accept_key`` its keys.
- The voice WebSocket end to end through a raw-socket client: two turns, a
  ``reset`` and a turn after it, on a block-causal model (the streaming
  encoder; the engine gets ``audio_embeds``) and on a model without a
  latency block (the batch path). Every event (apart from ``ttft_s``, a
  time) and each ``turn_end`` text equal the JAX server's on the same
  weights (fp32).
- A turn whose speech outgrows the encoder window falls back to the batch
  path, as the reference does: the same events and text as the JAX server,
  the engine given ``audio_values``, and the rest of the connection batch.
- Any other error of the streaming encoder ends the handler: nothing is
  submitted. A client that drops mid-reply: the reply is cancelled and no
  page of the paged engine stays in use.
- The queue C repair: with two adapters, one decoder-only, a request with
  precomputed embeddings warns only for the adapter with an encoder half,
  and once.
"""

import functools
import logging
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tiny_tokenizer
from tests.test_voice_demo import _silence, _speech, _WsClient
from ultravox_torch.inference.serving import api_server as tapi
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.inference.serving import websocket as tws
from ultravox_torch.models import config as tc
from ultravox_torch.models import processor as tproc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.utils import vad as tvad
from ultravox_tpu.inference.serving import api_server as japi
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.inference.serving import websocket as jws
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import processor as jproc
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.utils import vad as jvad

SR = 16000
FRAME = 1365  # the demo page's 4096-sample buffer at 48 kHz, at 16 kHz
REPLY_TOKENS = 24


# -- VAD and the WebSocket codec --------------------------------------------


STREAMS = {
    "segments": (dict(pause_ms=300, min_speech_ms=200),
                 lambda: np.concatenate([_silence(0.3), _speech(0.8), _silence(0.6)])),
    "short_blips": (dict(pause_ms=300, min_speech_ms=400),
                    lambda: np.concatenate([_speech(0.15), _silence(0.8)])),
    "utterances_and_flush": (dict(pause_ms=300, min_speech_ms=200),
                             lambda: np.concatenate([_speech(0.6, seed=1), _silence(0.5),
                                                     _speech(0.7, seed=2)])),
    "defaults_irregular": ({}, lambda: np.concatenate([_silence(0.2), _speech(1.3, seed=3),
                                                       _silence(0.9), _speech(0.4, seed=4),
                                                       _silence(0.8)])),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_reply_on_pause_matches_jax(name):
    kw, make = STREAMS[name]
    stream = make()
    jv, tv = jvad.ReplyOnPause(jvad.VadConfig(**kw)), tvad.ReplyOnPause(tvad.VadConfig(**kw))
    chunk = 1600 if kw else FRAME
    n_utt = 0
    for i in range(0, len(stream), chunk):
        a, b = jv.process(stream[i: i + chunk]), tv.process(stream[i: i + chunk])
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b, a)
            n_utt += 1
        pa, pb = jv.partial(), tv.partial()
        assert (pa is None) == (pb is None) and tv.in_speech == jv.in_speech
        if pa is not None:
            np.testing.assert_array_equal(pb, pa)
    a, b = jv.flush(), tv.flush()
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(b, a)
        n_utt += 1
    assert n_utt == {"segments": 1, "short_blips": 0, "utterances_and_flush": 2,
                     "defaults_irregular": 2}[name]


def test_websocket_accept_key():
    assert tws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    for key in ("x", "AQIDBAUGBwgJCgsMDQ4PEA==", "k" * 40):
        assert tws.accept_key(key) == jws.accept_key(key)


# -- the voice WebSocket, port against JAX ----------------------------------


def _cfg(c, streaming):
    audio = dict(d_model=32, num_layers=1, num_heads=2, ffn_dim=64)
    if streaming:
        audio["max_source_positions"] = 128  # 2.56 s: one window of 8 blocks of 16
    return c.UltravoxConfig(
        audio_config=c.WhisperEncoderConfig(**audio),
        text_config=c.DecoderConfig(
            vocab_size=384, hidden_size=48, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12),
        hidden_size=64,
        audio_latency_block_size=16 if streaming else None,
    )


def _params(jcfg, tcfg):
    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    params = {k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
              for k, v in params.items()}
    return params, from_jax_params(jax.tree.map(np.asarray, params), tcfg)


def _voice_api(m_api, m_proc, engine, tok, context):
    """A ServingAPI whose voice replies stop at REPLY_TOKENS tokens, with the
    processor chunking audio at the encoder's window (``context`` mel
    frames), so the batch path serves audio longer than one window."""
    proc = m_proc.UltravoxProcessor(tok, audio_context_size=context)
    coll = m_proc.DataCollatorWithAudio(pad_token_id=tok.pad_token_id, pad_multiple=1,
                                        mel_pad_multiple=context, max_audio_len=context)
    api = m_api.ServingAPI(engine, proc, coll, model_name="ultravox")
    api.handle_voice_ws = functools.partial(type(api).handle_voice_ws, api,
                                            max_tokens=REPLY_TOKENS)
    return api


def _serve(api, make_handler):
    api.engine.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(api))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _spy_submit(engine, log):
    """Log (what carried the audio, request) of every submit."""
    submit = engine.submit

    def spy(batch, **kw):
        req = submit(batch, **kw)
        log.append(("audio_embeds" if kw.get("audio_embeds") is not None else
                    "audio_values" if batch.get("audio_values") is not None else "text", req))
        return req

    engine.submit = spy


def _make_servers(streaming):
    jcfg, tcfg = _cfg(jc, streaming), _cfg(tc, streaming)
    jparams, tparams = _params(jcfg, tcfg)
    tok = make_tiny_tokenizer()
    context = jcfg.audio_config.max_context_length
    kw = dict(num_slots=2, max_seq_len=256, prefill_len_buckets=(64, 128, 256),
              mel_len_buckets=(context,))
    teng = tserve.ServingEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    jeng = jserve.ServingEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    logs = ([], [])
    _spy_submit(teng, logs[0])
    _spy_submit(jeng, logs[1])
    servers = [_serve(_voice_api(tapi, tproc, teng, tok, context), tapi.make_handler),
               _serve(_voice_api(japi, jproc, jeng, tok, context), japi.make_handler)]
    return servers, (teng, jeng), logs


@pytest.fixture(scope="module")
def voice_servers():
    """kind ("streaming" or "batch") -> (port's port, JAX's port, the port
    engine's submit log, the JAX engine's), each pair started once."""
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = _make_servers(kind == "streaming")
        servers, _, logs = made[kind]
        return servers[0].server_address[1], servers[1].server_address[1], logs[0], logs[1]

    yield get
    for servers, engines, _ in made.values():
        for s, e in zip(servers, engines):
            s.shutdown()
            s.server_close()
            e.stop()


def _pcm(audio):
    return (np.clip(audio, -1, 1) * 32767).astype(np.int16)


def _turn(client, audio):
    """Send one utterance in FRAME-sample PCM16 frames; the events up to the
    turn's end, without ``ttft_s`` (a time)."""
    pcm = _pcm(audio)
    for i in range(0, len(pcm), FRAME):
        client.send(0x2, pcm[i: i + FRAME].tobytes())
    events = []
    while True:
        ev = client.recv_json()
        assert ev is not None
        ev.pop("ttft_s", None)
        events.append(ev)
        if ev["type"] == "turn_end":
            return events


def _conversation(port, turns):
    client = _WsClient("127.0.0.1", port, "/ws/voice")
    try:
        assert client.recv_json() == {"type": "ready"}
        out = []
        for audio in turns:
            if audio is None:
                client.send(0x1, b'{"type": "reset"}')
                assert client.recv_json() == {"type": "ready"}
                out.append("reset")
            else:
                out.append(_turn(client, audio))
        return out
    finally:
        client.close()


@pytest.mark.parametrize("kind", ["streaming", "batch"])
def test_voice_ws_matches_jax(voice_servers, kind):
    tport, jport, tlog, jlog = voice_servers(kind)
    t1 = np.concatenate([_speech(1.0), _silence(1.2)])
    t2 = np.concatenate([_speech(0.8, seed=7), _silence(1.2)])
    turns = [t1, t2, None, t1]
    del tlog[:], jlog[:]
    got, want = _conversation(tport, turns), _conversation(jport, turns)
    assert got == want
    replies = [t for t in got if t != "reset"]
    for events in replies:
        kinds = [e["type"] for e in events]
        assert kinds[0] == "utterance" and kinds[-1] == "turn_end" and "token" in kinds
        assert events[-1]["text"] == "".join(e["text"] for e in events if e["type"] == "token")
    # after the reset the conversation starts again: the first turn's reply
    assert replies[2] == replies[0] and replies[1][-1]["text"]
    path = "audio_embeds" if kind == "streaming" else "audio_values"
    assert [k for k, _ in tlog] == [k for k, _ in jlog] == [path] * 3
    assert all(r.generated >= 1 for _, r in tlog)


def test_voice_ws_window_overflow_falls_back_to_batch(voice_servers):
    """3 s of speech outgrows the streaming model's 2.56 s window: the
    handler leaves the streaming encoder (only on EncoderWindowExceeded) and
    the batch path, which chunks, serves this turn and the next."""
    tport, jport, tlog, jlog = voice_servers("streaming")
    turns = [np.concatenate([_speech(3.0, seed=5), _silence(1.2)]),
             np.concatenate([_speech(0.8, seed=7), _silence(1.2)])]
    del tlog[:], jlog[:]
    got, want = _conversation(tport, turns), _conversation(jport, turns)
    assert got == want
    assert got[0][0]["seconds"] > 128 * 2 * 160 / SR
    assert [k for k, _ in tlog] == [k for k, _ in jlog] == ["audio_values", "audio_values"]
    # the first turn's audio spans two encoder windows
    assert tlog[0][1].batch["audio_values"].shape[0] == 2


class _FakeConn:
    """The handler's view of a WebSocket: queued binary frames, then None."""

    open = True

    def __init__(self, pcm):
        self.frames = [(tws.OP_BIN, pcm[i: i + FRAME].tobytes()) for i in range(0, len(pcm), FRAME)]
        self.sent = []

    def recv(self):
        return self.frames.pop(0) if self.frames else None

    def send_text(self, text):
        self.sent.append(text)


def test_voice_ws_other_stream_errors_propagate(monkeypatch):
    """Only EncoderWindowExceeded sends a turn to the batch path: any other
    error of the streaming encoder ends the handler, and nothing is
    submitted."""
    from ultravox_torch.inference import streaming as tstream

    cfg = _cfg(tc, True)
    _, tparams = _params(_cfg(jc, True), cfg)
    engine = tserve.ServingEngine(tparams, cfg, num_slots=2, max_seq_len=256,
                                  cache_dtype=torch.float32, device="cpu",
                                  prefill_len_buckets=(64, 128, 256), mel_len_buckets=(256,))
    log = []
    _spy_submit(engine, log)
    api = _voice_api(tapi, tproc, engine, make_tiny_tokenizer(), 256)

    def boom(self, samples):
        raise RuntimeError("stream step failed")

    monkeypatch.setattr(tstream.StreamingAudioEncoder, "feed", boom)
    conn = _FakeConn(_pcm(np.concatenate([_speech(1.0), _silence(1.2)])))
    with pytest.raises(RuntimeError, match="stream step failed"):
        api.handle_voice_ws(conn)
    assert log == [] and conn.sent == ['{"type": "ready"}']


def test_voice_ws_client_drop_cancels_the_reply():
    cfg = _cfg(tc, True)
    _, tparams = _params(_cfg(jc, True), cfg)
    tok = make_tiny_tokenizer()
    engine = tserve.ServingEngine(
        tparams, cfg, num_slots=2, max_seq_len=256, cache_dtype=torch.float32, device="cpu",
        cache_mode="paged", page_size=16, prefill_len_buckets=(64, 128, 256),
        mel_len_buckets=(256,))
    log = []
    _spy_submit(engine, log)
    api = _voice_api(tapi, tproc, engine, tok, 256)
    api.handle_voice_ws = functools.partial(type(api).handle_voice_ws, api, max_tokens=200)
    server = _serve(api, tapi.make_handler)
    try:
        client = _WsClient("127.0.0.1", server.server_address[1], "/ws/voice")
        assert client.recv_json()["type"] == "ready"
        pcm = _pcm(np.concatenate([_speech(1.0), _silence(1.2)]))
        for i in range(0, len(pcm), FRAME):
            client.send(0x2, pcm[i: i + FRAME].tobytes())
        while client.recv_json()["type"] != "token":
            pass
        client.close()  # mid-reply
        req = log[0][1]
        deadline = time.monotonic() + 120
        while (engine._requests or engine._active) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not engine._requests and not engine._active
        assert req.generated < req.max_tokens  # cancelled, not decoded to its end
        assert engine.pages_in_use == 0
        assert sorted(engine._free_slots) == [0, 1]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()


# -- the queue C repair ------------------------------------------------------


def test_bypass_warning_only_for_an_adapter_with_an_encoder_half(caplog):
    """A request with precomputed audio_embeds bypasses the audio tower: the
    engine warns (once) when its adapter has an encoder half, and not for a
    decoder-only adapter."""
    cfg = _cfg(tc, False)
    _, tparams = _params(_cfg(jc, False), cfg)
    g = torch.Generator().manual_seed(0)

    def lora(tower, names, d_in, d_out, L):
        return {"layers": {n: {"lora_a": torch.randn((L, d_in, 2), generator=g) * 0.1,
                               "lora_b": torch.randn((L, 2, d_out), generator=g) * 0.1,
                               "lora_scale": torch.ones((L,))} for n in names}}

    lm = lora("language_model", ("q_proj",), 48, 48, 2)
    enc = lora("audio_tower", ("q_proj",), 32, 32, 1)
    adapters = {"dec": {"language_model": lm}, "both": {"language_model": lm, "audio_tower": enc}}
    engine = tserve.ServingEngine(tparams, cfg, num_slots=2, max_seq_len=128,
                                  cache_dtype=torch.float32, device="cpu",
                                  prefill_len_buckets=(64, 128), lora_adapters=adapters)
    assert engine._enc_adapter_names == {"both"}
    ids = np.arange(1, 21, dtype=np.int32)[None]
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids),
             "audio_token_len": np.array([4], np.int32),
             "audio_token_start_idx": np.array([3], np.int32),
             "audio_chunk_batch_idx": np.array([0], np.int32)}
    embeds = np.random.default_rng(0).standard_normal((1, 4, 48)).astype(np.float32)
    engine.start()
    try:
        with caplog.at_level(logging.WARNING, logger=tserve.logger.name):
            for name in ("dec", "both", "dec", "both", None):
                req = engine.submit(dict(batch), max_tokens=3, lora=name, audio_embeds=embeds)
                assert [e.finish_reason for e in engine.stream(req, timeout=120)][-1] == "length"
    finally:
        engine.stop()
    warned = [r.getMessage() for r in caplog.records if "bypassed" in r.getMessage()]
    assert len(warned) == 1 and "'both'" in warned[0]
