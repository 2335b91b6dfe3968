"""Int8 weights in the port, against the JAX package, on the CPU.

``_quantize_kernel`` and ``_quantize_embedding`` give the same bf16 scales
bit for bit, and the same int8 values for fp32 weights; for bf16 weights
XLA's CPU division, which is not correctly rounded, moves 1-6 in 10^4
values by one (the port's values are numpy's IEEE quotient). ``proj_apply``
in both regimes (w8a16 up to 32 activation rows, w8a8 above), the
dequantized ``embed_lookup`` and ``compute_logits`` through the tied
model's pretransposed int8 head equal JAX's bit for bit (the int8
accumulators are exact and the float steps run in the same order); an fp32
adapter on top adds fp32 summation-order noise (1e-6 relative, or one bf16
ulp after the cast). The int8 fused encoder (a bf16 tree) agrees with JAX's
within a bf16 tolerance: XLA computes a bf16 tanh-GELU with bf16 constants
and rounds after each step, PyTorch in fp32 once, so 40% of the stem's GELU
outputs differ by an ulp.

The engines run bf16 activations over int8 weights, and w8a8's per-row
quantizer is a step function: an ulp of difference can move a quantized
value by one. Two frameworks' greedy runs therefore part at near-ties,
and on weights that amplify differences they part often. The engine tests
run teacher-forced on weights at twice the init scale, both engines fed
the same tokens. The logits must agree within a relative RMS of 0.05 over
the run and 0.1 of the step's largest logit at any element (sound runs
read at most 0.032 and 0.066; the planted faults below read 0.079 and
0.122 on the same run), and the port's greedy token must equal JAX's at
every step where JAX's top-two gap exceeds twice that step's largest
logit difference. The multi-LoRA int8 ServingEngine gives the JAX
ServingEngine's tokens with the same options up to the first step where
they part, which must be such a near tie.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_parity import audio_batch, make_configs, make_params, serve, synth_audio
from ultravox_torch.inference import engine as tengine
from ultravox_torch.inference.serving import engine as tserve
from ultravox_torch.models import decoder as tdec
from ultravox_torch.models import lora as tlora
from ultravox_torch.models import whisper_encoder as tenc
from ultravox_torch.models.weights import from_jax_params
from ultravox_torch.ops import mel as tmel
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.inference.serving.engine import ServingEngine as JServe
from ultravox_tpu.models import decoder as jdec
from ultravox_tpu.models import lora as jlora
from ultravox_tpu.models import whisper_encoder as jenc
from ultravox_tpu.models.config import LoraConfig
from ultravox_tpu.ops import mel as jmel


def _t(a):
    """A JAX array as a torch tensor of the same dtype and bits."""
    return from_jax_params({"x": np.asarray(a)}, None)["x"]


# Bounds on int8 logits, port against JAX, teacher-forced (module
# docstring): the relative RMS over a run, and the largest difference at a
# step against that step's largest logit.
INT8_RMS_TOL = 0.05
INT8_ABS_TOL = 0.1


def _f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) else a.float().numpy()


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def calm():
    """Weights at twice the init scale (the LM only; audio tower and
    projector at the init scale): tokens still vary, and bf16 differences
    stay small through the layers."""
    from ultravox_tpu.models import ultravox as juv

    jcfg, tcfg = make_configs()
    base = juv.init_params(jcfg, jax.random.key(0))
    jparams = dict(base, language_model=jax.tree.map(
        lambda a: a * 2.0 if a.ndim >= 2 else a, base["language_model"]))
    return jcfg, tcfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_are_bit_equal(dtype):
    """Scales bit-equal; int8 values bit-equal for fp32 weights, and for
    bf16 ones equal to numpy's IEEE quotient, JAX's differing by one in at
    most 1 of 1000 (XLA's CPU division)."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((3, 64, 96)) * 0.05, jnp.float32).astype(dtype)
    e = jnp.asarray(rng.standard_normal((50, 64)), jnp.float32).astype(dtype)
    for (jq, js), (tq, ts), src, axis in (
        (jdec._quantize_kernel(w), tdec._quantize_kernel(_t(w)), w, -2),
        (jdec._quantize_embedding(e), tdec._quantize_embedding(_t(e)), e, -1),
    ):
        assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(ts), _f32(js))
        if dtype == "float32":
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            continue
        k = _f32(src)
        scale = np.maximum(np.abs(k).max(axis=axis, keepdims=True), 1e-8) / np.float32(127.0)
        np.testing.assert_array_equal(tq.numpy(), np.clip(np.round(k / scale), -127, 127))
        diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [4, 32, 33, 96])
def test_int8_proj_apply_matches_jax(rows, dtype, lora):
    """Both regimes on either side of the 32-row switch, with a bias:
    bit-equal. With an fp32 adapter on the int8 base: within 1e-6 relative
    (fp32) or one ulp (bf16), the delta's summation order."""
    rng = np.random.default_rng(rows)
    jq, js = jdec._quantize_kernel(jnp.asarray(rng.standard_normal((64, 48)) * 0.05, jnp.float32))
    p = {"kernel_q": jq, "scale": js, "bias": jnp.asarray(rng.standard_normal(48), jnp.bfloat16)}
    if lora:
        p.update(lora_a=jnp.asarray(rng.standard_normal((64, 4)), jnp.float32),
                 lora_b=jnp.asarray(rng.standard_normal((4, 48)), jnp.float32),
                 lora_scale=jnp.asarray(2.0, jnp.float32))
    x = jnp.asarray(rng.standard_normal((2, rows // 2, 64)), jnp.float32).astype(dtype)
    ref = _f32(jlora.proj_apply(x, p))
    out = tlora.proj_apply(_t(x), {k: _t(v) for k, v in p.items()})
    assert str(out.dtype)[6:] == dtype
    if not lora:
        np.testing.assert_array_equal(_f32(out), ref)
    else:
        tol = 1e-6 if dtype == "float32" else 2.0**-8
        np.testing.assert_allclose(_f32(out), ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_int8_decoder_tree_embed_and_tied_logits_match_jax(setup):
    """quantize_decoder_int8 on the fused, tied decoder: every int8 leaf and
    scale equal; the dequantized embedding rows and the logits through the
    materialised (D, V) head (w8a16 and w8a8) bit-equal."""
    jcfg, tcfg, jparams, tparams = setup
    jlm = jdec.quantize_decoder_int8(jdec.fuse_inference_params(jparams["language_model"],
                                                                jcfg.text_config))
    tlm = tdec.quantize_decoder_int8(tdec.fuse_inference_params(tparams["language_model"],
                                                                tcfg.text_config))
    assert set(tlm) == set(jlm) and "lm_head" in tlm and "embed_tokens" not in tlm
    assert tlm["lm_head"]["kernel_q"].is_contiguous()
    for name in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
        for leaf in ("kernel_q", "scale"):
            np.testing.assert_array_equal(_f32(tlm["layers"][name][leaf]),
                                          _f32(jlm["layers"][name][leaf]))
    ids = np.random.default_rng(1).integers(0, 512, (2, 5)).astype(np.int32)
    np.testing.assert_array_equal(_f32(tdec.embed_lookup(tlm, torch.from_numpy(ids))),
                                  _f32(jdec.embed_lookup(jlm, jnp.asarray(ids))))
    for rows in (3, 40):
        h = np.random.default_rng(rows).standard_normal((rows, 128)).astype(np.float32)
        ref = jdec.compute_logits(jlm, jcfg.text_config, jnp.asarray(h, jnp.bfloat16))
        out = tdec.compute_logits(tlm, tcfg.text_config, torch.from_numpy(h).bfloat16())
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_int8_fused_encoder_matches_jax(setup, monkeypatch):
    """quantize_encoder_int8 then fuse_encoder_inference_params: the fused
    int8 q/k/v leaves equal JAX's; the fused encoder's bf16 output agrees
    within a relative RMS error of 2^-5 and 2^-3 of max|ref| at any element
    (the GELU rounding of the module docstring), and each layer runs the
    port's qkv_head_transpose."""
    jcfg, tcfg, jparams, tparams = setup
    jt = jenc.fuse_encoder_inference_params(jenc.quantize_encoder_int8(jparams["audio_tower"]))
    tt = tenc.fuse_encoder_inference_params(tenc.quantize_encoder_int8(tparams["audio_tower"]))
    for leaf in ("kernel_q", "scale", "bias"):
        np.testing.assert_array_equal(_f32(tt["layers"]["qkv_proj"][leaf]),
                                      _f32(jt["layers"]["qkv_proj"][leaf]))
    assert tt["conv1"]["kernel"].dtype == torch.bfloat16
    mel = tmel.log_mel_spectrogram_np(synth_audio(1.5, 2))[None]
    lens = np.array([mel.shape[-1]], np.int32)
    calls = []
    orig = tenc.qkv_head_transpose
    monkeypatch.setattr(tenc, "qkv_head_transpose", lambda *a: calls.append(1) or orig(*a))
    ref = _f32(jenc.encoder_forward(jt, jcfg.audio_config, jnp.asarray(mel, jnp.bfloat16),
                                    jnp.asarray(lens), attn_impl="fused"))
    out = tenc.encoder_forward(tt, tcfg.audio_config, torch.from_numpy(mel).bfloat16(),
                               torch.from_numpy(lens), attn_impl="fused")
    assert out.dtype == torch.bfloat16 and len(calls) == jcfg.audio_config.num_layers
    out = _f32(out)
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 2.0**-5
    assert np.abs(out - ref).max() <= 2.0**-3 * np.abs(ref).max()


def _jax_forced(jeng, batch, steps: int, tokens=None):
    """JAX's engine: prefill, then decode fed ``tokens`` ((steps, B)) or,
    without them, its own greedy tokens. (logits (steps, B, V), tokens fed)."""
    b = jeng.pad_batch(batch)
    B = b["input_ids"].shape[0]
    logits, cache, pos = jeng._prefill(jeng.params, {k: jnp.asarray(v) for k, v in b.items()},
                                       jeng._ensure_cache(None, B, 128), jnp.asarray(0, jnp.int32))
    out, fed = [], []
    for s in range(steps):
        out.append(np.asarray(logits))
        fed.append(out[-1].argmax(-1) if tokens is None else np.reshape(tokens[s], (B,)))
        if s + 1 < steps:
            logits, cache, pos = jeng._decode(jeng.params, cache,
                                              jnp.asarray(fed[-1], jnp.int32), pos)
    return np.stack(out), np.stack(fed).astype(np.int32)


def _port_forced(teng, batch, tokens):
    """The port's engine fed ``tokens`` ((steps, B)): logits (steps, B, V)."""
    b = teng.pad_batch(batch)
    out = []
    with torch.inference_mode():
        logits, cache, pos = teng._prefill({k: torch.as_tensor(v) for k, v in b.items()},
                                           teng._ensure_cache(None, b["input_ids"].shape[0], 128), 0)
        for s, tok in enumerate(tokens):
            out.append(logits.numpy())
            if s + 1 < len(tokens):
                logits, cache, pos = teng._decode(cache, torch.from_numpy(np.asarray(tok)), pos)
    return np.stack(out)


def _rel_rms(out, ref) -> float:
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _check_int8_logits(ref, out):
    """Teacher-forced logits (steps, B, V) of JAX (ref) and the port (out)
    within the int8 bounds; the greedy tokens equal wherever JAX's top-two
    gap exceeds twice the step's largest logit difference. Returns the
    (steps, B) near ties, where they may differ."""
    d = np.abs(out - ref).max(-1)
    rms, worst = _rel_rms(out, ref), float((d / np.abs(ref).max(-1)).max())
    print(f"int8 logits against JAX: relative RMS {rms:.4f}, largest difference {worst:.4f} "
          f"of the step's largest logit")
    assert worst <= INT8_ABS_TOL and rms <= INT8_RMS_TOL, (rms, worst)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    near = top2[..., 1] - top2[..., 0] <= 2 * d
    assert ((ref.argmax(-1) == out.argmax(-1)) | near).all()
    return near


def test_int8_generate_matches_jax_from_raw_audio(calm):
    """GenerationEngine(quantize="int8") with the fused encoder: int8
    decoder and Whisper tower, each side computing its own log-mel from the
    same audio; teacher-forced on JAX's greedy tokens against JAX's engine
    as the module docstring sets out. (The xla encoder's int8 pieces are
    held bit for bit above.)"""
    jcfg, tcfg, jparams, tparams = calm
    kw = dict(max_cache_len=128, encoder_attn_impl="fused", prefill_attn_impl="fused",
              quantize="int8")
    jeng = JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    teng = tengine.GenerationEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    assert "kernel_q" in teng.params["audio_tower"]["layers"]["qkv_proj"]
    assert "embed_tokens_q" in teng.params["language_model"]
    comp = jcfg.audio_token_compression
    tbatch = audio_batch(tmel.log_mel_spectrogram_np, comp)
    ref, toks = _jax_forced(jeng, audio_batch(jmel.log_mel_spectrogram_np, comp), 12)
    _check_int8_logits(ref, _port_forced(teng, tbatch, toks))
    out = teng.generate(tbatch, max_new_tokens=12)
    assert all(len(set(row)) > 3 for row in out.token_ids), "degenerate tokens prove little"


def _lm_adapters(jparams, scale=0.5):
    from ultravox_tpu.models.lora import DECODER_TARGETS

    adapters = {}
    for i, name in enumerate(("a", "b")):
        lm = jlora.add_lora(jparams["language_model"],
                            LoraConfig(r=4, target_modules=("q_proj", "v_proj", "gate_proj")),
                            jax.random.key(20 + i), DECODER_TARGETS)
        for tgt in ("q_proj", "v_proj", "gate_proj"):
            shp = lm["layers"][tgt]["lora_b"].shape
            lm["layers"][tgt]["lora_b"] = jax.random.normal(jax.random.key(60 + i), shp) * scale
        adapters[name] = {"language_model": lm}
    return adapters


@pytest.fixture(scope="module")
def int8_served(calm):
    """The JAX ServingEngine(quantize="int8", lora_adapters=...) on requests
    over adapter "a", the base model and adapter "b", and JAX's int8
    GenerationEngine per adapter teacher-forced on each request's served
    tokens. The prompts are longer than 32 tokens: a shorter one would
    prefill in w8a16 offline (its own rows) but in w8a8 in the serving
    engine (a 64-token bucket)."""
    jcfg, tcfg, jparams, tparams = calm
    adapters = _lm_adapters(jparams)
    tad = {k: from_jax_params(jax.tree.map(np.asarray, v), tcfg) for k, v in adapters.items()}
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 512, (1, 36)).astype(np.int32)
    ids2 = rng.integers(1, 512, (1, 41)).astype(np.int32)
    batches = [{"input_ids": x, "attention_mask": np.ones_like(x)} for x in (ids, ids, ids, ids2)]
    names = ["a", None, "b", "a"]
    kw = dict(lora_adapters=adapters, num_slots=2, max_seq_len=128, prefill_len_buckets=(64,),
              mel_len_buckets=(400,), quantize="int8", cache_mode="slots", decode_block_steps=4)
    served = serve(JServe(jparams, jcfg, cache_dtype=jnp.float32, **kw), batches, names, 8)
    assert [f for _, f in served] == ["length"] * 4
    assert len({tuple(t) for t, _ in served[:3]}) == 3, "the adapters must change the tokens"
    engines = {n: JEngine(dict(jparams, **(adapters[n] if n else {})), jcfg, max_cache_len=128,
                          cache_dtype=jnp.float32, quantize="int8") for n in (None, "a", "b")}
    logits = []
    for (toks, _), b, n in zip(served, batches, names):
        ref, fed = _jax_forced(engines[n], b, len(toks), np.asarray(toks)[:, None])
        # the offline engine's greedy tokens are the served ones
        np.testing.assert_array_equal(ref.argmax(-1), fed)
        logits.append(ref)
    kw.update(lora_adapters=tad)
    return tcfg, tparams, tad, batches, names, [t for t, _ in served], logits, kw


def _offline(tcfg, tparams, tad, name):
    return tengine.GenerationEngine(dict(tparams, **(tad[name] if name else {})), tcfg,
                                    max_cache_len=128, cache_dtype=torch.float32, device="cpu",
                                    quantize="int8")


def test_int8_multi_lora_serving(int8_served):
    """ServingEngine(quantize="int8", lora_adapters=...): an int8 fused
    decoder under two banked adapters and the base model gives the JAX
    ServingEngine's greedy tokens with the same options, up to the first
    step where the two part, which must be a near tie of JAX's own
    teacher-forced logits on that adapter; the port's offline engine on
    each adapter holds against JAX's within the int8 bounds."""
    tcfg, tparams, tad, batches, names, jtoks, jlogits, kw = int8_served
    teng = tserve.ServingEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    assert "kernel_q" in teng.params["language_model"]["layers"]["qkv_proj"]
    assert set(teng._lora_banks) == {"qkv_proj", "gateup_proj"}
    out = serve(teng, batches, names, 8)
    assert [f for _, f in out] == ["length"] * 4
    for (toks, _), want, ref, b, n in zip(out, jtoks, jlogits, batches, names):
        near = _check_int8_logits(ref, _port_forced(_offline(tcfg, tparams, tad, n), b,
                                                    np.asarray(want)[:, None]))
        k = next((s for s, (x, y) in enumerate(zip(toks, want)) if x != y), len(want))
        print(f"adapter {n}: the JAX ServingEngine's first {k} of {len(want)} tokens")
        assert k == len(want) or near[k, 0], (n, k, toks, want)


@pytest.mark.parametrize("fault", ["fp32_scales", "w8a16_always"])
def test_int8_logit_bounds_reject_planted_faults(int8_served, monkeypatch, fault):
    """The int8 bounds are not loose: the port with a planted fault fails
    them against the same JAX logits, on the first request (adapter "a").
    fp32 scales (in place of bf16) make the dequantized embedding fp32 and
    the residual stream with it; w8a16 at every row count skips the
    prefill's activation quantization. (On the base model both faults stay
    within the sound runs' spread: the bit-equal tests above are what
    catch them everywhere.)"""
    tcfg, tparams, tad, batches, names, jtoks, jlogits, _ = int8_served
    if fault == "fp32_scales":
        quantize = tdec._quantize_kernel

        def fp32_scales(kernel, axis=-2):
            k32 = kernel.float()
            scale = k32.abs().amax(dim=axis, keepdim=True).clamp(min=1e-8) / 127.0
            return quantize(kernel, axis)[0], scale

        monkeypatch.setattr(tdec, "_quantize_kernel", fp32_scales)
    else:
        monkeypatch.setattr(tlora, "W8A16_MAX_ROWS", 1 << 30)
    out = _port_forced(_offline(tcfg, tparams, tad, names[0]), batches[0],
                       np.asarray(jtoks[0])[:, None])
    rms = _rel_rms(out, jlogits[0])
    print(f"int8 logits against JAX with {fault}: relative RMS {rms:.4f}")
    assert rms > INT8_RMS_TOL
