"""The port's host front end and HTTP server on the CPU, against the JAX
package.

- Processor and collator: every case of tests/test_processor.py and the
  ``audio_token_lens=`` form give identical keys, ids, lengths and starts,
  and bit-equal ``audio_values`` (both sides run the numpy mel).
- ``resample`` (24 kHz to 16 kHz) is bit-equal to scipy's
  ``resample_poly`` and to the JAX package's scipy path (tolerance found:
  0). The JAX package prefers its own C++ resampler where it builds; at
  24 to 16 kHz that one gives twice the RMS of scipy's (0.424 against
  0.212 on a 0.3 chirp), so it is not the reference here.
- WAV round trip; the stop-string helpers.
- A port ServingAPI and a JAX ServingAPI on the same weights (fp32), each
  behind a ThreadingHTTPServer on 127.0.0.1:0, get the same bodies: their
  JSON answers agree field by field apart from ids and timestamps, logprob
  values within 1e-4.
- Seeded sampling at a temperature above 0 is not compared with JAX (the
  port draws from a hash, not threefry): the same body and seed repeat, and
  ``n: 2`` gives two choices, the first equal to the seeded ``n: 1`` one.
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import scipy.signal
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tiny_tokenizer
from ultravox_torch.data import sample as tsample
from ultravox_torch.inference.serving import api_server as tapi
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import config as tc
from ultravox_torch.models import processor as tproc
from ultravox_torch.models import tokenizer as ttok
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.utils import audio as taudio
from ultravox_tpu.data import sample as jsample
from ultravox_tpu.inference.serving import api_server as japi
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import processor as jproc
from ultravox_tpu.models import tokenizer as jtok
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.utils import audio as jaudio

SR = 16000
LP_TOL = 1e-4
ENGINE = dict(num_slots=4, max_seq_len=128, prefill_len_buckets=(64, 128), mel_len_buckets=(400,))


def _tone(seconds, sr=SR, f0=220.0, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * (f0 + 300.0 * t) * t) + 0.01 * rng.standard_normal(t.size)
    return x.astype(np.float32)


# -- processor and collator --------------------------------------------------


def _case_text_only(m, proc):
    return [proc(text="hello world")]


def _case_single_audio(m, proc):
    return [proc(text="transcribe <|audio|> please", audio=np.zeros(8000, np.float32))]


def _case_short_audio(m, proc):
    return [proc(text="<|audio|>", audio=np.zeros(100, np.float32))]


def _case_multiple_audios(m, proc):
    return [proc(text="a <|audio|> b <|audio|> c", audios=[_tone(1.0), _tone(0.25, seed=1)])]


def _case_long_audio(m, proc):
    audio = np.random.default_rng(0).standard_normal(SR * 60).astype(np.float32)
    return [proc(text="x <|audio|> y", audio=audio)]


def _case_placeholder_errors(m, proc):
    audio = np.zeros(8000, np.float32)
    out = []
    for kw in (dict(text="no placeholder here", audio=audio),
               dict(text="<|audio|> and <|audio|>", audio=audio),
               dict(text="x <|audio|> y", audios=[audio, audio, audio]),
               dict(text="<|audio|>", audio_token_lens=[3, 4])):
        with pytest.raises(ValueError) as info:
            proc(**kw)
        out.append({"error": np.asarray(str(info.value))})
    return out


def _case_collator(m, proc):
    f1 = proc(text="one <|audio|> x", audio=_tone(1.0))
    f2 = proc(text="two <|audio|> y", audio=np.zeros(SR * 40, np.float32))
    f3 = proc(text="text only")
    return [m.DataCollatorWithAudio(pad_token_id=proc.tokenizer.pad_token_id)([f1, f2, f3])]


def _case_alt_fields(m, proc):
    f = proc(text="hello <|audio|> world", audio=np.zeros(8000, np.float32))
    f["labels"] = np.full_like(f["input_ids"][0], -100)
    f["alt_input_ids"] = np.asarray([1, 2, 3], np.int32)
    f["alt_labels"] = np.asarray([-100, 2, 3], np.int32)
    coll = m.DataCollatorWithAudio(pad_token_id=proc.tokenizer.pad_token_id,
                                   include_alt_fields=True)
    return [coll([f])]


def _case_audio_token_lens(m, proc):
    """The streaming voice path's form: known token counts, no features."""
    feats = proc(text="<|start|>user\n<|audio|> then <|audio|><|eot_id|>",
                 audio_token_lens=[5, 2])
    batch = m.DataCollatorWithAudio(pad_token_id=proc.tokenizer.pad_token_id, pad_multiple=1)(
        [{"input_ids": feats["input_ids"]}])
    return [feats, batch]


CASES = [_case_text_only, _case_single_audio, _case_short_audio, _case_multiple_audios,
         _case_long_audio, _case_placeholder_errors, _case_collator, _case_alt_fields,
         _case_audio_token_lens]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[6:])
def test_processor_and_collator_match_jax(case):
    tok = make_tiny_tokenizer()
    want = case(jproc, jproc.UltravoxProcessor(tok))
    got = case(tproc, tproc.UltravoxProcessor(tok))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_audio_token_helpers_match_jax():
    tok = make_tiny_tokenizer()
    assert ttok.AUDIO_TOKEN == jtok.AUDIO_TOKEN
    assert ttok.get_audio_token_id(tok) == jtok.get_audio_token_id(tok) is None


# -- host DSP and codecs -----------------------------------------------------


def test_resample_matches_scipy_and_jax():
    x = _tone(1.0, sr=24000)
    got = taudio.resample(x, 24000, 16000)
    assert got.dtype == np.float32 and got.shape == (16000,)
    np.testing.assert_array_equal(got, scipy.signal.resample_poly(x, 2, 3).astype(np.float32))
    saved = jaudio._USE_NATIVE
    jaudio._USE_NATIVE = False  # the JAX package's scipy path
    try:
        np.testing.assert_array_equal(got, jaudio.resample(x, 24000, 16000))
    finally:
        jaudio._USE_NATIVE = saved
    np.testing.assert_array_equal(taudio.resample(x, 16000, 16000), x)


def test_wav_round_trip():
    x = _tone(0.5)
    for sr in (16000, 24000):
        data = tsample.audio_to_wav_bytes(x, sr)
        assert data == jsample.audio_to_wav_bytes(x, sr)
        got, got_sr = tsample.audio_from_wav_bytes(data)
        want, want_sr = jsample.audio_from_wav_bytes(data)
        assert got_sr == want_sr == sr
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, x, atol=1.0 / 32767 + 1e-7)


def test_stop_string_helpers():
    for mod in (tapi, japi):
        assert mod._find_stop("hello world", ("wor",)) == 6
        assert mod._find_stop("hello world", ("zzz",)) == -1
        assert mod._find_stop("ab ab", ("ab", "b a")) == 0
        assert mod._stop_holdback("hello wo", ("world",)) == 2
        assert mod._stop_holdback("hello", ("world",)) == 0
        assert mod._stop_holdback("ab", ("ab",)) == 0
        assert mod._stop_holdback("xa", ("ab", "a")) == 1
    assert tapi._parse_stops({"stop": "x"}) == ("x",)
    with pytest.raises(ValueError):
        tapi._parse_stops({"stop": ["a"] * (tapi.MAX_STOPS + 1)})
    assert (tapi.MAX_CHOICES, tapi.MAX_STOPS) == (japi.MAX_CHOICES, japi.MAX_STOPS)


# -- the HTTP servers --------------------------------------------------------


def _cfg(c):
    return c.UltravoxConfig(
        audio_config=c.WhisperEncoderConfig(d_model=32, num_layers=1, num_heads=2, ffn_dim=64),
        text_config=c.DecoderConfig(
            vocab_size=384, hidden_size=48, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=12),
        hidden_size=64,
    )


def _start(api, handler):
    api.engine.start()
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler(api))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


@pytest.fixture(scope="module")
def servers():
    """(port url, JAX url, (port engine, JAX engine)) on the same weights. The projector and
    decoder matrices are scaled up from the 0.02 init, so greedy tokens vary
    from step to step."""
    jcfg, tcfg = _cfg(jc), _cfg(tc)
    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    params = {k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
              for k, v in params.items()}
    tparams = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    tok = make_tiny_tokenizer()
    apis = []
    for m, eng in ((tproc, tserve.ServingEngine(tparams, tcfg, cache_dtype=torch.float32,
                                                device="cpu", **ENGINE)),
                   (jproc, jserve.ServingEngine(params, jcfg, cache_dtype=jnp.float32, **ENGINE))):
        coll = m.DataCollatorWithAudio(pad_token_id=tok.pad_token_id, pad_multiple=1,
                                       mel_pad_multiple=400)
        apis.append((m.UltravoxProcessor(tok), coll, eng))
    tapi_ = tapi.ServingAPI(apis[0][2], apis[0][0], apis[0][1], model_name="ultravox")
    japi_ = japi.ServingAPI(apis[1][2], apis[1][0], apis[1][1], model_name="ultravox")
    srv = [_start(tapi_, tapi.make_handler), _start(japi_, japi.make_handler)]
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in srv]
    yield urls[0], urls[1], (tapi_.engine, japi_.engine)
    for s, a in zip(srv, (tapi_, japi_)):
        s.shutdown()
        s.server_close()
        a.engine.stop()


def _post(url, body):
    req = urllib.request.Request(f"{url}/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            data = r.read().decode()
            code = r.status
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    if body.get("stream"):
        lines = data.strip().split("\n\n")
        assert lines[-1] == "data: [DONE]"
        return code, [json.loads(line[6:]) for line in lines[:-1]]
    return code, json.loads(data)


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=60) as r:
        return json.load(r)


def _same(got, want, path="$"):
    """Field by field, ids and timestamps apart; logprobs within LP_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            if k not in ("id", "created"):
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif path.endswith(".logprob"):
        assert abs(got - want) <= LP_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _wav_b64(audio, sr=SR):
    return base64.b64encode(tsample.audio_to_wav_bytes(audio, sr)).decode()


def _chat(text="hello world", **kw):
    return {"model": "ultravox", "max_tokens": 12,
            "messages": [{"role": "user", "content": text}], **kw}


def _audio_chat(**kw):
    content = [
        {"type": "text", "text": "transcribe "},
        {"type": "input_audio", "input_audio": {"data": _wav_b64(_tone(0.5)), "format": "wav"}},
        {"type": "text", "text": " and "},
        {"type": "audio_url",
         "audio_url": {"url": "data:audio/wav;base64," + _wav_b64(_tone(0.4, f0=330.0, seed=2))}},
    ]
    return {"model": "ultravox", "max_tokens": 10,
            "messages": [{"role": "user", "content": content}], **kw}


BODIES = {
    "audio": _audio_chat(),
    "audio_stream": _audio_chat(stream=True),
    "n2_greedy": _chat(n=2, temperature=0),
    "n2_stream": _chat(n=2, temperature=0, stream=True),
    "logprobs": _chat(logprobs=True, top_logprobs=3),
    "logprobs_stream": _chat(logprobs=True, top_logprobs=2, stream=True),
    "explicit_zeros": _chat(temperature=5.0, top_p=0),
    "oversized": _chat("hello world " * 40),
    "too_many_choices": _chat(n=tapi.MAX_CHOICES + 1),
}


@pytest.mark.parametrize("name", list(BODIES))
def test_http_matches_jax(servers, name):
    turl, jurl, _ = servers
    body = BODIES[name]
    tcode, got = _post(turl, body)
    jcode, want = _post(jurl, body)
    assert tcode == jcode
    if body.get("stream") and body.get("n", 1) > 1:
        # choices interleave as their tokens arrive: compare each choice's text
        got, want = (["".join(c["choices"][0]["delta"].get("content", "") for c in chunks
                              if c["choices"][0]["index"] == i) for i in range(2)]
                     for chunks in (got, want))
    _same(got, want)
    if name == "audio":
        assert got["usage"]["completion_tokens"] == 10 and got["choices"][0]["message"]["content"]
    if name == "explicit_zeros":
        # top_p 0 keeps only the top token: greedy whatever the temperature
        greedy = _post(turl, _chat(temperature=0))[1]
        assert got["choices"][0]["message"]["content"] == greedy["choices"][0]["message"]["content"]
    if name == "oversized":
        assert got["choices"][0]["finish_reason"] == "prompt_too_long"
    if name == "too_many_choices":
        assert tcode == 400 and "n must be" in got["error"]


def test_http_stop_strings_match_jax(servers):
    """A stop string taken from the middle of the greedy text: the text is cut
    before it, and streamed with holdback, on both servers alike."""
    turl, jurl, _ = servers
    full = _post(jurl, _chat())[1]["choices"][0]["message"]["content"]
    stop = full[3:5]
    assert len(full) > 5 and stop
    for stream in (False, True):
        body = _chat(stop=[stop, "zzzz"], stream=stream)
        got, want = _post(turl, body)[1], _post(jurl, body)[1]
        _same(got, want)
        if not stream:
            assert got["choices"][0]["message"]["content"] == full[: full.find(stop)]
            assert got["choices"][0]["finish_reason"] == "stop"
        else:
            assert "".join(c["choices"][0]["delta"].get("content", "") for c in got) == \
                full[: full.find(stop)]


def test_http_models_and_health_match_jax(servers):
    turl, jurl, engines = servers
    # a reply cut at a stop string is cancelled after its answer went out:
    # wait until both engines have retired every request
    deadline = time.monotonic() + 60
    while any(e._requests or e._active for e in engines) and time.monotonic() < deadline:
        time.sleep(0.05)
    for path in ("/v1/models", "/health", "/v1/health"):
        _same(_get(turl, path), _get(jurl, path))
    with pytest.raises(urllib.error.HTTPError) as info:
        _get(turl, "/nope")
    assert info.value.code == 404
    for path in ("/", "/voice"):
        with urllib.request.urlopen(f"{turl}{path}", timeout=60) as r:
            assert r.status == 200 and b"<html>" in r.read()


def test_seeded_sampling_repeats(servers):
    turl, _, _ = servers
    body = _chat(temperature=0.9, seed=77)
    first = _post(turl, body)[1]
    again = _post(turl, body)[1]
    assert first["choices"] == again["choices"]
    two = _post(turl, dict(body, n=2))[1]
    assert [c["index"] for c in two["choices"]] == [0, 1]
    assert two["choices"][0]["message"] == first["choices"][0]["message"]
    assert all(c["finish_reason"] in ("length", "stop") for c in two["choices"])
    assert two["usage"]["prompt_tokens"] == first["usage"]["prompt_tokens"]
