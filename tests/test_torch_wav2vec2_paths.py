"""Every path that carries the wav2vec2 tower, the port against the JAX
package on the CPU (fp32; tiny wav2vec2 + llama models of
``tests/torch_parity.py`` in both norm styles, the tiny tokenizer):

- the processor's features from raw audio (and audio shorter than the
  receptive field) and ``ultravox_forward``'s logits, within 1e-4;
- greedy tokens of ``GenerationEngine`` (plain and
  ``encoder_attn_impl="fused"``) and of ``ServingEngine`` (slots and paged,
  sample buckets) identical to the JAX GenerationEngine's on the same tree
  and the same padded audio; ``quantize="int8"`` (the decoder only, the
  tower untouched in both packages) teacher-forced on JAX's tokens within
  ``tests/test_torch_int8.py``'s bounds;
- a checkpoint written by ``save_pretrained`` through
  ``load_ultravox_checkpoint`` (against the JAX loader), ``UltravoxInference``
  against JAX's, and the server ``build_api`` builds, over HTTP; the JAX
  package's own server cannot build this model;
- one KL train step (loss within 1e-5 relative + 1e-6 absolute, projector
  gradients within 1e-4 of their norm) and ``train()`` for 2 steps from a
  local ``audio_model`` directory (a ``Wav2Vec2ForCTC``-layout file with
  ``weight_g`` / ``weight_v``), against the JAX loop.
"""

import inspect
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.helpers import make_tiny_tokenizer
from tests.test_torch_int8 import _check_int8_logits, _jax_forced, _port_forced
from tests.test_torch_train_loop import JAX_YAML, PORT_YAML, _argv, assert_logs_match
from tests.torch_parity import W2V_STYLES, make_w2v_configs, make_w2v_params, synth_audio, w2v_hf_dict
from ultravox_torch.data.sample import VoiceSample
from ultravox_torch.inference.engine import GenerationEngine
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.inference.ultravox_infer import UltravoxInference, load_ultravox_checkpoint
from ultravox_torch.models import config as tc
from ultravox_torch.models import ultravox as tuv
from ultravox_torch.models import weights as tweights
from ultravox_torch.models.processor import DataCollatorWithAudio, make_processor
from ultravox_torch.tools import publish as tpublish
from ultravox_torch.training import checkpoint as tckpt
from ultravox_torch.training import config as tcfg_lib
from ultravox_torch.training import train as ttrain
from ultravox_torch.training import train_step as tts
from ultravox_tpu.data.sample import VoiceSample as JVoiceSample
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.inference.serving import engine as jserve
from ultravox_tpu.inference.ultravox_infer import UltravoxInference as JUltravoxInference
from ultravox_tpu.inference.ultravox_infer import (
    load_ultravox_checkpoint as jload_ultravox_checkpoint,
)
from ultravox_tpu.models import config as jc
from ultravox_tpu.models import ultravox as juv
from ultravox_tpu.models.processor import UltravoxProcessor as JProcessor
from ultravox_tpu.training import config as jcfg_lib
from ultravox_tpu.training import train as jtrain
from ultravox_tpu.training import train_step as jts

MAX_NEW = 10
SAMPLES = (4000, 2500)  # 0.25 and 0.16 s: 199 and 124 frames, 25 and 16 audio tokens


@pytest.fixture(scope="module")
def tok():
    return make_tiny_tokenizer()


@pytest.fixture(scope="module", params=W2V_STYLES)
def model(request, tok):
    """(style, JAX config, port config, JAX params, port params, a batch of
    two rows collated from raw audio by the port's processor)."""
    jcfg, tcfg = make_w2v_configs(request.param)
    jp, tp = make_w2v_params(jcfg, tcfg)
    proc = make_processor(tok, tcfg)
    feats = [proc(text=f"row {i}: transcribe <|audio|> now", audio=synth_audio(n / 16000, i))
             for i, n in enumerate(SAMPLES)]
    coll = DataCollatorWithAudio(pad_token_id=tok.pad_token_id,
                                 max_audio_len=proc.audio_context_size)
    return request.param, jcfg, tcfg, jp, tp, coll(feats)


def test_processor_and_logits_match_jax(model, tok):
    style, jcfg, tcfg, jp, tp, batch = model
    proc = make_processor(tok, tcfg)
    jproc = JProcessor(tok, stack_factor=8, audio_arch="wav2vec2",
                       wav2vec2_config=jcfg.audio_config)
    assert proc.audio_arch == "wav2vec2" and proc.audio_context_size == 480000
    assert tcfg.audio_config.min_samples == 30
    for audio in (synth_audio(0.25, 0), synth_audio(20 / 16000, 1)):  # 4000 and 20 samples
        got = proc(text="a <|audio|> b", audio=audio)
        want = jproc(text="a <|audio|> b", audio=audio)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["audio_values"].shape == (1, 1, 30)  # padded to the receptive field
    assert batch["audio_values"].shape == (2, 1, 4000)
    np.testing.assert_array_equal(batch["audio_lens"], SAMPLES)
    np.testing.assert_array_equal(batch["audio_token_len"], [25, 16])
    # at the init's scale: the tokens' 8x decoder amplifies fp32 rounding
    jp, tp = make_w2v_params(jcfg, tcfg, lm_scale=1.0)
    got = tuv.ultravox_forward(tp, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax.jit(juv.ultravox_forward, static_argnums=1)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def _jax_tokens(jp, jcfg, batches, quantize=None):
    eng = JEngine(jp, jcfg, max_cache_len=128, cache_dtype=jnp.float32, quantize=quantize)
    return [eng.generate(b, max_new_tokens=MAX_NEW).token_ids for b in batches]


def test_generation_engine_matches_jax(model):
    style, jcfg, tcfg, jp, tp, batch = model
    want = _jax_tokens(jp, jcfg, [batch])[0]
    assert all(len(set(r)) > 3 for r in want), "degenerate tokens prove little"
    for kw in ({}, {"encoder_attn_impl": "fused"}):
        eng = GenerationEngine(tp, tcfg, max_cache_len=128, cache_dtype=torch.float32,
                               device="cpu", **kw)
        assert eng.generate(batch, max_new_tokens=MAX_NEW).token_ids == want, kw
        assert eng.generate_fused(batch, max_new_tokens=MAX_NEW).token_ids == want, kw
    # int8: the decoder only (the tower keeps its fp32 tree in both
    # packages); bf16 activations over int8 weights round otherwise than
    # XLA's, so the engines are held teacher-forced on JAX's greedy tokens
    # within tests/test_torch_int8.py's bounds, on its calm weights (the
    # decoder at twice the init scale)
    jp, tp = make_w2v_params(jcfg, tcfg, lm_scale=2.0)
    kw = dict(max_cache_len=128, quantize="int8")
    teng = GenerationEngine(tp, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    jeng = JEngine(jp, jcfg, cache_dtype=jnp.float32, **kw)
    for tree in (teng.params["audio_tower"], jax.tree.map(np.asarray, jeng.params["audio_tower"])):
        assert tree["layers"]["q_proj"]["kernel"].dtype == np.float32 or (
            tree["layers"]["q_proj"]["kernel"].dtype == torch.float32)
    assert "kernel_q" in teng.params["language_model"]["layers"]["qkv_proj"]
    ref, toks = _jax_forced(jeng, batch, MAX_NEW)
    _check_int8_logits(ref, _port_forced(teng, batch, toks))


def _request(batch, i, pad_to):
    """Row i as a one-request batch, its audio padded to ``pad_to`` samples
    (the engine's bucket, so both engines encode the same array)."""
    out = {k: batch[k][i: i + 1] for k in ("input_ids", "attention_mask")}
    for k in ("audio_lens", "audio_token_len", "audio_token_start_idx"):
        out[k] = batch[k][i: i + 1]
    av = batch["audio_values"][i: i + 1]
    out["audio_values"] = np.pad(av, ((0, 0), (0, 0), (0, pad_to - av.shape[-1])))
    out["audio_chunk_batch_idx"] = np.zeros((1,), np.int32)
    return out


@pytest.mark.parametrize("mode", ["slots", "paged"])
def test_serving_engine_matches_jax(model, mode):
    style, jcfg, tcfg, jp, tp, batch = model
    buckets = (4800, 9600)
    reqs = [_request(batch, i, 4800) for i in range(2)]
    want = [t[0] for t in _jax_tokens(jp, jcfg, reqs)]
    kw = dict(page_size=16) if mode == "paged" else {}
    srv = tserve.ServingEngine(
        tp, tcfg, num_slots=2, max_seq_len=128, cache_dtype=torch.float32, cache_mode=mode,
        prefill_len_buckets=(64, 128), mel_len_buckets=buckets, prefill_chunk_tokens=16,
        decode_block_steps=4, device="cpu", **kw)
    srv.start()
    try:
        # the second request unpadded: the engine pads it to the same bucket
        sub = [srv.submit(dict(r), max_tokens=MAX_NEW) for r in (reqs[0], _request(batch, 1, 4000))]
        got = [[ev.token_id for ev in srv.stream(r, timeout=120) if ev.token_id is not None]
               for r in sub]
    finally:
        srv.stop()
    assert got == want


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tok):
    """The stable variant saved by the port's save_pretrained, fp32, with the
    tiny tokenizer."""
    jcfg, tcfg = make_w2v_configs("layer")
    jp, tp = make_w2v_params(jcfg, tcfg)
    out = str(tmp_path_factory.mktemp("w2v_ckpt"))
    tpublish.save_pretrained(tp, tcfg, out, tok, shards=2)
    return out, tcfg, tp


def _samples():
    rng = np.random.default_rng(0)
    return [
        ("transcribe <|audio|> please", synth_audio(0.3, 1)),
        ("<|audio|>", (rng.standard_normal(2000) * 0.1).astype(np.float32)),
        ("hello world how are you", None),
    ]


def _pair(text, audio):
    if audio is None:
        return VoiceSample.from_prompt(text), JVoiceSample.from_prompt(text)
    return (VoiceSample.from_prompt_and_audio(text, audio, 16000),
            JVoiceSample.from_prompt_and_audio(text, audio, 16000))


def test_checkpoint_and_ultravox_inference_match_jax(ckpt):
    out, tcfg, tp = ckpt
    cfg, params, _ = load_ultravox_checkpoint(out, torch.float32, device="cpu")
    jcfg, jparams, _ = jload_ultravox_checkpoint(out, jnp.float32)
    assert cfg == tcfg and cfg.audio_arch == jcfg.audio_arch == "wav2vec2"
    flat = dict(tts._path_items(params))
    jflat = {jts._path_str(p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert list(flat) == list(jflat)
    for k, v in tts._path_items(tp):
        np.testing.assert_allclose(flat[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(flat[k].numpy(), jflat[k], rtol=1e-6, atol=1e-7, err_msg=k)
    port = UltravoxInference(out, dtype=torch.float32, max_cache_len=256, device="cpu")
    jinf = JUltravoxInference(out, dtype=jnp.float32, max_cache_len=256)
    assert port.processor.audio_arch == "wav2vec2"
    assert port.collator.max_audio_len == 480000
    texts = set()
    for text, audio in _samples():
        ps, js = _pair(text, audio)
        a, b = port.infer(ps, max_tokens=MAX_NEW), jinf.infer(js, max_tokens=MAX_NEW)
        assert (a.text, a.input_tokens, a.output_tokens) == (b.text, b.input_tokens, b.output_tokens)
        texts.add(a.text)
    assert len(texts) == 3, texts  # (ids past the tiny tokenizer's 192 decode to nothing)


def test_build_api_serves_wav2vec2_over_http(ckpt):
    """The port's server builds the raw-sample processor, the collator's
    cap of 30 s of samples and sample buckets (4-30 s), and serves each
    sample over HTTP as the offline door answers it."""
    from ultravox_torch.inference.serving.api_server import build_api, make_server
    from ultravox_torch.tools.infer_api import OpenAIInference

    out, _, _ = ckpt
    api, _ = build_api(["--model", out, "--device", "cpu", "--num-slots", "2",
                        "--max-seq-len", "256", "--cache-mode", "paged", "--page-size", "16"])
    eng = api.engine
    assert api.processor.audio_arch == "wav2vec2" and api.collator.max_audio_len == 480000
    assert eng.mel_len_buckets == (64000, 160000, 320000, 480000)
    assert eng.resolved_flags["encoder_attn_impl"] == "xla"
    door = UltravoxInference(out, dtype=torch.float32, max_cache_len=256, device="cpu")
    # the door pads audio to the engine's first bucket: the tower encodes
    # the same array (another padding gives the same frames only up to fp32
    # rounding, which these weights' 8x decoder may turn into another token)
    door.collator.mel_pad_multiple = eng.mel_len_buckets[0]
    server = make_server(api, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = OpenAIInference(f"http://127.0.0.1:{server.server_address[1]}", timeout=120)
        for text, audio in _samples():
            ps, _ = _pair(text, audio)
            want = door.infer(ps, max_tokens=MAX_NEW)
            got = client.infer(ps, max_tokens=MAX_NEW)
            assert (got.text, got.input_tokens, got.output_tokens) == (
                want.text, want.input_tokens, want.output_tokens)
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_jax_server_cannot_build_wav2vec2(ckpt, monkeypatch):
    """A fault of the reference, pinned: the JAX package's server reads
    ``num_mel_bins`` from the audio config, which a wav2vec2 config has
    not, and its ServingEngine's default buckets (400-3000) stop at 0.19 s
    of raw samples."""
    from ultravox_tpu.inference.serving import api_server as japi

    out, _, _ = ckpt
    monkeypatch.setattr(sys, "argv", ["api_server", "--model", out])
    with pytest.raises(AttributeError, match="num_mel_bins"):
        japi.main()
    default = inspect.signature(jserve.ServingEngine).parameters["mel_len_buckets"].default
    assert default == (400, 1000, 2000, 3000)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        jserve._bucket(16000, default)  # one second of audio


def test_train_step_matches_jax(model, tmp_path):
    """One KL step with the projector trainable: the loss, the projector's
    gradients and the step's metrics against the JAX package's; the state
    saved and restored bit for bit, and the projector exported."""
    style, jcfg, tcfg, _, _, batch = model
    jp, tp = make_w2v_params(jcfg, tcfg, lm_scale=2.0)  # the calm weights of the int8 check
    rng = np.random.default_rng(5)
    B, T = batch["input_ids"].shape
    labels = np.full((B, T), -100, np.int64)
    labels[:, -8:] = rng.integers(1, 384, (B, 8))
    alt_ids = rng.integers(1, 384, (B, 24)).astype(np.int64)
    alt_labels = np.full((B, 24), -100, np.int64)
    alt_labels[:, -8:] = labels[:, -8:]
    full = dict(batch, labels=labels, alt_input_ids=alt_ids,
                alt_attention_mask=np.ones_like(alt_ids), alt_labels=alt_labels)
    jbatch = {k: jnp.asarray(v) for k, v in full.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in full.items()}
    jlc = jc.LossConfig(loss_function=jc.LossFunction.KL_DIVERGENCE)
    tlc = tc.LossConfig(loss_function=tc.LossFunction.KL_DIVERGENCE)

    jloss, jgrad = jax.jit(jax.value_and_grad(lambda proj: juv.ultravox_loss(
        dict(jp, projector=proj), jcfg, jbatch, jlc, remat=True, vocab_chunk=16)))(jp["projector"])
    proj = tts._map_paths(lambda _, v: v.detach().clone().requires_grad_(True), tp["projector"])
    tloss = tuv.ultravox_loss(dict(tp, projector=proj), tcfg, tbatch, tlc, remat=True,
                              attn_impl="flash", vocab_chunk=16)
    leaves = [v for _, v in tts._path_items(proj)]
    tgrad = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5, atol=1e-6)
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrad)]
    diff = np.sqrt(sum(((g.numpy() - j) ** 2).sum() for g, j in zip(tgrad, jleaves)))
    norm = np.sqrt(sum((j**2).sum() for j in jleaves))
    assert norm > 0 and diff <= 1e-4 * norm, (diff, norm)

    # one step of the port's train step on the list tree: its partition is
    # the JAX package's, and its metrics are the loss and gradient above
    trainable = (r".*projector/.*",)
    jtr, jfr = jts.partition_params(jp, jts.trainable_mask(jp, trainable))
    topt = tts.make_optimizer(1e-3, warmup_steps=1, total_steps=10)
    tstate, ttemplate = tts.init_train_state(tp, topt, trainable, device="cpu")
    assert list(tstate.trainable) == list(jtr) and list(tstate.frozen) == list(jfr)
    tstep = tts.make_train_step(tcfg, tlc, topt, ttemplate, remat=True, attn_impl="flash",
                                vocab_chunk=16)
    tstate, tm = tstep(tstate, tbatch)
    np.testing.assert_allclose(float(tm["loss"]), float(jloss), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), norm, rtol=1e-5)
    path = tckpt.save_checkpoint(str(tmp_path), tstate)
    fresh, _ = tts.init_train_state(tp, topt, trainable, device="cpu")
    back = tckpt.restore_checkpoint(path, fresh)
    assert back.step == 1 and list(back.trainable) == list(tstate.trainable)
    assert all(torch.equal(back.trainable[k], v) for k, v in tstate.trainable.items())
    exported = tckpt.export_safetensors(back, str(tmp_path / "model.safetensors"))
    assert sorted(exported) == sorted(
        "multi_modal_projector." + k for k in tweights.projector_to_hf(tp["projector"]))


def test_train_loop_from_audio_model_dir(tmp_path, tok):
    """``train()`` for 2 steps of ``test_train.yaml`` with its audio tower
    read from a local ``audio_model`` directory: a tiny wav2vec2
    ``config.json`` and a ``Wav2Vec2ForCTC``-layout file (``wav2vec2.``
    prefix, ``weight_g`` / ``weight_v``). The port's model factory reads the
    same tower as the JAX package's; from the same initial tree the two
    loops log the same losses and norms."""
    import json

    jcfg, tcfg = make_w2v_configs("layer")
    _, tp = make_w2v_params(jcfg, tcfg)
    audio_dir = tmp_path / "w2v"
    os.makedirs(audio_dir)
    with open(audio_dir / "config.json", "w") as f:
        json.dump(w2v_hf_dict("layer"), f)
    sd = {f"wav2vec2.{k}": v for k, v in tpublish._wav2vec2_to_hf(tp["audio_tower"], tcfg).items()}
    sd["lm_head.weight"] = torch.zeros(32, 64)
    tweights.save_safetensors(sd, str(audio_dir / "model.safetensors"))
    tok_dir = str(tmp_path / "tok")
    tok.save_pretrained(tok_dir)
    overrides = {"audio_model": str(audio_dir), "audio_model_config": "null"}

    held = {}
    orig_j = jtrain.create_model_pack

    def jpack(c):
        p = orig_j(c)
        held["params"] = jax.tree.map(np.array, p.params)
        return p

    jc_ = jcfg_lib.get_train_config(_argv(JAX_YAML, tmp_path / "jax", tok_dir, overrides))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "create_model_pack", jpack)
        jtrain.train(jc_)

    orig_t = ttrain.create_model_pack

    def tpack(c):
        p = orig_t(c)
        assert p.config.audio_arch == "wav2vec2" and p.processor.audio_arch == "wav2vec2"
        assert p.collator.max_audio_len == 480000
        jt = {jts._path_str(k): v for k, v in jax.tree_util.tree_flatten_with_path(
            held["params"]["audio_tower"])[0]}
        tt = dict(tts._path_items(p.params["audio_tower"]))
        assert list(tt) == list(jt)
        for k, v in tt.items():  # the same file through both converters
            np.testing.assert_allclose(v.numpy(), jt[k], rtol=1e-6, atol=1e-7, err_msg=k)
        p.params = tweights.from_jax_params(held["params"], p.config, device="cpu")
        return p

    tc_ = tcfg_lib.get_train_config(
        _argv(PORT_YAML, tmp_path / "port", tok_dir, overrides) + ["--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "create_model_pack", tpack)
        ttrain.train(tc_)
    assert_logs_match(jc_.output_dir, tc_.output_dir)
    assert os.path.exists(os.path.join(tc_.output_dir, "checkpoint-2", "state.pt"))
