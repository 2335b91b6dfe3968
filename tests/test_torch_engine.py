"""The port's GenerationEngine against the JAX package's, end to end from raw
audio: each side computes its own log-mel from the same waveforms, then
greedy generation must give identical tokens."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import audio_batch, make_configs, make_params
from ultravox_torch.inference import engine as tengine
from ultravox_torch.ops import mel as tmel
from ultravox_tpu.inference.engine import GenerationEngine as JEngine
from ultravox_tpu.ops import mel as jmel


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = make_configs()
    jparams, tparams = make_params(jcfg, tcfg)
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_generate_matches_jax_from_raw_audio(setup, impl):
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(max_cache_len=128, encoder_attn_impl=impl, prefill_attn_impl=impl)
    jeng = JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    teng = tengine.GenerationEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    comp = jcfg.audio_token_compression
    ref = jeng.generate(audio_batch(jmel.log_mel_spectrogram_np, comp), max_new_tokens=12)
    out = teng.generate(audio_batch(tmel.log_mel_spectrogram_np, comp), max_new_tokens=12)
    assert out.prompt_lens == ref.prompt_lens == [32, 28]
    assert out.token_ids == ref.token_ids
    assert all(len(set(row)) > 3 for row in out.token_ids), "degenerate tokens prove little"


def test_generate_with_flash_encoder_matches_jax(setup):
    """encoder_attn_impl="flash" (the encoder's attention in the
    flash_attention kernel; its plain version on the CPU) gives the JAX
    engine's greedy tokens with the same option (its Pallas flash kernel in
    interpret mode)."""
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(max_cache_len=128, encoder_attn_impl="flash")
    jeng = JEngine(jparams, jcfg, cache_dtype=jnp.float32, **kw)
    teng = tengine.GenerationEngine(tparams, tcfg, cache_dtype=torch.float32, device="cpu", **kw)
    comp = jcfg.audio_token_compression
    ref = jeng.generate(audio_batch(jmel.log_mel_spectrogram_np, comp), max_new_tokens=12)
    out = teng.generate(audio_batch(tmel.log_mel_spectrogram_np, comp), max_new_tokens=12)
    assert out.token_ids == ref.token_ids
    assert all(len(set(row)) > 3 for row in out.token_ids), "degenerate tokens prove little"


def test_conversation_cache_reuse_matches_one_shot(setup):
    """A second turn written after a returned cache equals one prefill of
    the concatenated prompt (greedy). The second turn outgrows the first
    turn's 256-slot cache, so the cache is grown on the way."""
    _, tcfg, _, tparams = setup
    eng = tengine.GenerationEngine(
        tparams, tcfg, max_cache_len=512, cache_dtype=torch.float32, device="cpu",
        prefill_attn_impl="fused",
    )
    rng = np.random.default_rng(9)
    a = rng.integers(1, 512, (1, 240)).astype(np.int32)
    b = rng.integers(1, 512, (1, 12)).astype(np.int32)
    first = eng.generate({"input_ids": a, "attention_mask": np.ones_like(a)},
                         max_new_tokens=1, return_cache=True)
    second = eng.generate({"input_ids": b, "attention_mask": np.ones_like(b)},
                          max_new_tokens=6, cache=first.cache, start_pos=240)
    assert first.cache.max_len == 256
    ab = np.concatenate([a, b], axis=1)
    whole = eng.generate({"input_ids": ab, "attention_mask": np.ones_like(ab)}, max_new_tokens=6)
    assert second.token_ids == whole.token_ids


def test_default_device_is_cuda_and_never_falls_back(setup, monkeypatch):
    _, tcfg, _, tparams = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.GenerationEngine(tparams, tcfg)


@pytest.mark.parametrize("kw", [
    dict(decode_attn_impl="bogus"), dict(quantize="int4"), dict(encoder_attn_impl="bogus"),
])
def test_unported_options_raise(setup, kw):
    """An unknown decode_attn_impl, quantize mode or encoder_attn_impl raises
    ValueError (int8 runs: tests/test_torch_int8.py; the flash encoder:
    test_generate_with_flash_encoder_matches_jax)."""
    _, tcfg, _, tparams = setup
    with pytest.raises(ValueError):
        tengine.GenerationEngine(tparams, tcfg, device="cpu", **kw)
