"""The port's offline front doors on the CPU against the JAX package.

A checkpoint directory (``tests/assets/tiny_ultravox`` with
``tests/helpers.py::make_tiny_tokenizer`` saved beside it) loaded by both
packages in fp32: ``UltravoxInference`` / ``LocalInference`` greedy text and
token counts (exact), streamed chunks joined equal to ``infer``, the
conversation mode's prefix reuse equal to a full replay and to the JAX
package's turns, ``pipeline()`` (and ``ultravox_torch.pipeline``) with its
dtype and prompt handling, ``OpenAIInference`` against the port's own
server on an ephemeral port, and ``api_server.build_api`` from ``argv`` with
``--device cpu`` (plain and ``--spec-decode ngram``) serving the same text.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.helpers import make_tiny_tokenizer
from tests.torch_parity import synth_audio
from ultravox_torch.data.sample import VoiceSample
from ultravox_torch.inference import base as tbase
from ultravox_torch.inference.infer import LocalInference, _split_thinking
from ultravox_torch.inference.ultravox_infer import UltravoxInference
from ultravox_tpu.data.sample import VoiceSample as JVoiceSample
from ultravox_tpu.inference.ultravox_infer import UltravoxInference as JUltravoxInference

FIXTURE = "tests/assets/tiny_ultravox"
MAX = 8


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The fixture's checkpoint with the tiny tokenizer saved beside it."""
    out = tmp_path_factory.mktemp("ckpt")
    for name in ("config.json", "model.safetensors"):
        shutil.copy(f"{FIXTURE}/{name}", out / name)
    make_tiny_tokenizer().save_pretrained(out)
    return str(out)


@pytest.fixture(scope="module")
def doors(ckpt):
    port = UltravoxInference(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu")
    jax_inf = JUltravoxInference(ckpt, dtype=jnp.float32, max_cache_len=256)
    return port, jax_inf


def _samples():
    rng = np.random.default_rng(0)
    return [
        ("hello world how are you", None),
        ("transcribe <|audio|> please", synth_audio(1.0, 1)),
        ("<|audio|>", (rng.standard_normal(9000) * 0.1).astype(np.float32)),
    ]


def _pair(text, audio, sr=16000):
    if audio is None:
        return VoiceSample.from_prompt(text), JVoiceSample.from_prompt(text)
    return (VoiceSample.from_prompt_and_audio(text, audio, sr),
            JVoiceSample.from_prompt_and_audio(text, audio, sr))


def test_ultravox_inference_matches_jax(doors):
    port, jax_inf = doors
    assert port.tokenizer.padding_side == "right"
    assert port.tokenizer.pad_token_id == jax_inf.tokenizer.pad_token_id
    assert port.engine.encoder_attn_impl == "xla" and not port.engine.decode_kernel
    texts = set()
    for text, audio in _samples():
        ps, js = _pair(text, audio)
        a, b = port.infer(ps, max_tokens=MAX), jax_inf.infer(js, max_tokens=MAX)
        assert (a.text, a.input_tokens, a.output_tokens, a.thinking_content) == (
            b.text, b.input_tokens, b.output_tokens, b.thinking_content)
        texts.add(a.text)
    assert len(texts) == 3 and all(texts), texts


def test_batch_and_resampled_audio_match_jax(doors):
    """infer_batch of two samples (one at 24 kHz, resampled on the host)."""
    port, jax_inf = doors
    audio24 = synth_audio(1.2, 4)[: int(1.2 * 24000 * 2 / 3)]
    pairs = [_pair("hi <|audio|>", audio24, 24000), _pair("the quick brown fox", None)]
    got = port.infer_batch([p for p, _ in pairs], max_tokens=MAX)
    want = jax_inf.infer_batch([j for _, j in pairs], max_tokens=MAX)
    assert [(o.text, o.input_tokens, o.output_tokens) for o in got] == [
        (o.text, o.input_tokens, o.output_tokens) for o in want]


def test_fused_greedy_decode_matches_generate(ckpt, doors):
    port, _ = doors
    fused = UltravoxInference(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu",
                              fused_greedy_decode=True)
    for text, audio in _samples()[:2]:
        ps, _ = _pair(text, audio)
        assert fused.infer(ps, max_tokens=MAX).text == port.infer(ps, max_tokens=MAX).text


def test_stream_chunks_join_to_infer(doors):
    port, _ = doors
    for text, audio in _samples():
        ps, _ = _pair(text, audio)
        msgs = list(port.infer_stream(ps, max_tokens=MAX))
        stats = msgs[-1]
        assert isinstance(stats, tbase.InferenceStats) and stats.ttft_s is not None
        chunks = [m.text for m in msgs[:-1]]
        assert all(isinstance(m, tbase.InferenceChunk) for m in msgs[:-1])
        ref = port.infer(ps, max_tokens=MAX)
        assert "".join(chunks) == ref.text
        assert (stats.input_tokens, stats.output_tokens) == (ref.input_tokens, ref.output_tokens)


def test_stream_worker_without_inference_mode_and_errors(ckpt):
    """The stream's worker thread enters inference mode itself (weights that
    require grad must not build a graph), and an engine error ends the
    stream with the exception."""
    inf = UltravoxInference(ckpt, dtype=torch.float32, max_cache_len=32, device="cpu")
    for leaf in inf.engine.params["language_model"]["layers"].values():
        if isinstance(leaf, dict):
            for t in leaf.values():
                t.requires_grad_(True)
    msgs = list(inf.infer_stream(VoiceSample.from_prompt("hi"), max_tokens=3))
    assert isinstance(msgs[-1], tbase.InferenceStats)
    with pytest.raises(ValueError, match="max_cache_len"):
        list(inf.infer_stream(VoiceSample.from_prompt("a long prompt " * 8), max_tokens=30))


def test_conversation_reuse_matches_replay_and_jax(ckpt):
    """Three turns (audio, text, audio): the reusing engine equals a full
    replay and the JAX package's conversation, and later turns prefill only
    their suffix."""
    rng = np.random.default_rng(5)
    turns = [("listen <|audio|>", (rng.standard_normal(6000) * 0.1).astype(np.float32)),
             ("and then?", None),
             ("also <|audio|>", (rng.standard_normal(4000) * 0.1).astype(np.float32))]
    kw = dict(dtype=torch.float32, max_cache_len=256, device="cpu", conversation_mode=True)
    conv, replay = UltravoxInference(ckpt, **kw), UltravoxInference(ckpt, **kw)
    jconv = JUltravoxInference(ckpt, dtype=jnp.float32, max_cache_len=256, conversation_mode=True)
    outs, replays, jouts, prefilled = [], [], [], []
    for text, audio in turns:
        ps, js = _pair(text, audio)
        outs.append(conv.infer(ps, max_tokens=5).text)
        prefilled.append((conv.last_prefilled_tokens, len(conv._conv_tokens)))
        replay._conv_tokens, replay._conv_cache = [], None
        replays.append(replay.infer(ps, max_tokens=5).text)
        jouts.append(jconv.infer(js, max_tokens=5).text)
    assert outs == replays == jouts
    assert all(n < total for n, total in prefilled[1:])
    assert len(conv.past_messages) == 6 and len(conv.past_audios) == 2
    # a streamed turn continues the same conversation
    msgs = list(conv.infer_stream(VoiceSample.from_prompt("more"), max_tokens=4))
    msgs_j = list(jconv.infer_stream(JVoiceSample.from_prompt("more"), max_tokens=4))
    assert "".join(m.text for m in msgs[:-1]) == "".join(m.text for m in msgs_j[:-1])
    assert msgs[-1].input_tokens == msgs_j[-1].input_tokens
    conv.update_conversation()
    assert conv.past_messages == [] and conv._conv_cache is None


def test_pipeline_matches_jax(ckpt):
    import ultravox_torch
    from ultravox_tpu.pipeline import pipeline as jpipeline

    pipe = ultravox_torch.pipeline(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu")
    jpipe = jpipeline(ckpt, dtype=jnp.float32, max_cache_len=256)
    audio = synth_audio(1.0, 3)
    cases = [
        {"audio": audio, "sampling_rate": 16000},
        {"audio": (audio * 32767).astype(np.int16), "sampling_rate": 16000, "prompt": "what is"},
        {"audio": audio.astype(np.float64), "turns": [{"role": "user", "content": "hi"},
                                                     {"role": "assistant", "content": "yes"}]},
        {"turns": [{"role": "user", "content": "just text"}]},
    ]
    for inputs in cases:
        assert pipe(inputs, max_new_tokens=MAX) == jpipe(inputs, max_new_tokens=MAX)
    # the lazy entry point works more than once
    again = ultravox_torch.pipeline(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu",
                                    chat_template="{{ messages[0].content }}")
    assert again.tokenizer.chat_template == "{{ messages[0].content }}"
    with pytest.raises(NotImplementedError, match="mesh"):
        UltravoxInference(ckpt, device="cpu", mesh=object())


def test_split_thinking_and_extra_stop_tokens(ckpt):
    assert _split_thinking("<think> a b </think> answer") == ("a b", "answer")
    assert _split_thinking("plain") == (None, "plain")
    inf = UltravoxInference(ckpt, dtype=torch.float32, max_cache_len=256, device="cpu")
    li = LocalInference(inf.engine.params, inf.cfg, inf.processor, max_cache_len=64,
                        cache_dtype=torch.float32, device="cpu",
                        extra_stop_tokens=("<|start|>", "not-a-token"))
    assert set(li.engine.stop_token_ids) == {inf.tokenizer.eos_token_id,
                                             inf.tokenizer.convert_tokens_to_ids("<|start|>")}


def _serve_in_thread(api):
    from ultravox_torch.inference.serving.api_server import make_server

    server = make_server(api, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


@pytest.mark.parametrize("spec", [False, True])
def test_build_api_and_openai_client(ckpt, doors, spec):
    """build_api from argv (fp32 on the CPU), served on an ephemeral port:
    OpenAIInference plain and streamed gives the offline door's text, and
    each request alone equals submit on the same engine."""
    from ultravox_torch.inference.serving.api_server import build_api
    from ultravox_torch.tools.infer_api import OpenAIInference

    port_inf, _ = doors
    argv = ["--model", ckpt, "--device", "cpu", "--num-slots", "2", "--max-seq-len", "256",
            "--cache-mode", "paged", "--page-size", "16"]
    if spec:
        argv += ["--spec-decode", "ngram", "--spec-k", "4"]
    api, args = build_api(argv)
    eng = api.engine
    assert (args.port, eng.device.type, eng.cache_mode) == (8000, "cpu", "paged")
    assert eng.cache.k.dtype == torch.float32  # the CPU's dtype
    assert eng.spec_decode == ("ngram" if spec else None) and eng.spec_k == (4 if spec else 8)
    server, thread = _serve_in_thread(api)
    try:
        client = OpenAIInference(f"http://127.0.0.1:{server.server_address[1]}", timeout=120)
        for text, audio in _samples():
            ps, _ = _pair(text, audio)
            want = port_inf.infer(ps, max_tokens=MAX)
            got = client.infer(ps, max_tokens=MAX)
            assert (got.text, got.output_tokens) == (want.text, want.output_tokens)
            assert got.input_tokens == want.input_tokens
            msgs = list(client.infer_stream(ps, max_tokens=MAX))
            assert "".join(m.text for m in msgs[:-1]) == want.text
            # submit on the same engine, the request alone
            feats = port_inf._dataproc(ps)
            req = eng.submit(port_inf.collator([feats]), max_tokens=MAX)
            ids = [ev.token_id for ev in eng.stream(req, timeout=60) if ev.token_id is not None]
            assert port_inf.tokenizer.decode(ids, skip_special_tokens=True) == want.text
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        thread.join(timeout=10)


def test_main_defaults_to_the_card(ckpt, monkeypatch):
    from ultravox_torch.inference.serving.api_server import build_api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_api(["--model", ckpt])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UltravoxInference(ckpt)
