"""Shared fixtures for the ultravox_torch parity tests (the tests/test_torch_*
modules): one small config built in both packages, JAX parameters handed to
the port as numpy, and seeded synthetic audio batches. JAX is imported only
inside the functions that need it.

The encoder width is 128 (2 heads of 64) so that the JAX package's fused
encoder takes its head-major kernels (ln_qkv_head_fused and
attention_headmajor need D, 3D and T multiples of 128); head_dim 64 is a
width the port's CUDA attention kernel is built for.
"""

from __future__ import annotations

import numpy as np

SR = 16000


def make_configs():
    from ultravox_torch.models import config as tc
    from ultravox_tpu.models import config as jc

    def mk(c):
        return c.UltravoxConfig(
            audio_config=c.WhisperEncoderConfig(
                d_model=128, num_layers=2, num_heads=2, ffn_dim=256,
                max_source_positions=1500,
            ),
            text_config=c.DecoderConfig(
                vocab_size=512, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                rope_theta=500000.0, rope_scaling=(32.0, 1.0, 4.0, 8192),
                tie_word_embeddings=True,
            ),
            hidden_size=256,
            projector_ln_mid=True,
        )

    return mk(jc), mk(tc)


def make_params(jcfg, tcfg):
    """(JAX params, the same values as port params). Matrices are scaled up
    from the 0.02 init so greedy tokens vary from step to step and a wrong
    path shows as different tokens; the encoder's only 2x, since larger
    attention logits there amplify fp32 summation-order noise past 1e-4."""
    import jax

    from ultravox_torch.models.weights import from_jax_params
    from ultravox_tpu.models import ultravox as juv

    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 2.0, "projector": 8.0, "language_model": 8.0}
    params = {
        k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
        for k, v in params.items()
    }
    return params, from_jax_params(jax.tree.map(np.asarray, params), tcfg)


def synth_audio(seconds: float, seed: int) -> np.ndarray:
    """Chirp + harmonics + noise at 16 kHz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f0 = 150.0 + 30.0 * seed
    x = 0.3 * np.sin(2 * np.pi * (f0 + 300.0 * t) * t)
    x += 0.1 * np.sin(2 * np.pi * 3 * f0 * t) + 0.02 * rng.standard_normal(t.size)
    return x.astype(np.float32)


def audio_batch(mel_fn, compression: int, seed: int = 0):
    """Two requests (1.5 s and 1.0 s of audio) spliced at position 4 of a
    32-token prompt; the second prompt has 4 padding positions."""
    mels = [mel_fn(synth_audio(s, i)) for i, s in enumerate((1.5, 1.0))]
    L = max(m.shape[1] for m in mels)
    av = np.zeros((2, mels[0].shape[0], L), np.float32)
    for i, m in enumerate(mels):
        av[i, :, : m.shape[1]] = m
    lens = np.array([m.shape[1] for m in mels], np.int32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 512, (2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.int32)
    mask[1, 28:] = 0
    return {
        "input_ids": ids,
        "attention_mask": mask,
        "audio_values": av,
        "audio_lens": lens,
        "audio_token_len": (-(-lens // compression)).astype(np.int32),
        "audio_token_start_idx": np.array([4, 4], np.int32),
        "audio_chunk_batch_idx": np.array([0, 1], np.int32),
    }


def drain(engine, req, timeout: float = 300):
    """A request's stream read to its end: (token ids, finish reason)."""
    ids, finish = [], None
    for ev in engine.stream(req, timeout=timeout):
        if ev.token_id is None:
            finish = ev.finish_reason
            break
        ids.append(ev.token_id)
    return ids, finish


def serve(engine, batches, names, max_tokens: int):
    """Start a ServingEngine (either package's), submit every batch at once
    (request i on adapter names[i]), drain each, stop: [(ids, finish)]."""
    engine.start()
    try:
        reqs = [engine.submit(dict(b), max_tokens=max_tokens, lora=n) for b, n in zip(batches, names)]
        return [drain(engine, r) for r in reqs]
    finally:
        engine.stop()


# --------------------------------------------------------------------------
# the wav2vec2 tower: a tiny HF config in both norm styles, composed with the
# llama decoder above (vocab 384, the tiny tokenizer's)
# --------------------------------------------------------------------------

W2V_STYLES = ("group", "layer")


def w2v_hf_dict(style: str, pos_taps: int = 16) -> dict:
    """A tiny wav2vec2 ``config.json`` dict: ``"group"`` is the base
    variant (GroupNorm, post-norm blocks), ``"layer"`` the stable
    large-lv60 one (LayerNorm convs with bias, pre-norm blocks)."""
    return {
        "model_type": "wav2vec2", "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "conv_dim": [32, 32, 32],
        "conv_kernel": [10, 3, 2], "conv_stride": [5, 2, 2], "conv_bias": style == "layer",
        "feat_extract_norm": style, "do_stable_layer_norm": style == "layer",
        "num_conv_pos_embeddings": pos_taps, "num_conv_pos_embedding_groups": 4,
    }


def make_w2v_configs(style: str):
    """(JAX config, port config) of a tiny wav2vec2 + llama speech model."""
    from ultravox_torch.models import config as tc
    from ultravox_tpu.models import config as jc

    def mk(c):
        return c.UltravoxConfig(
            audio_config=c.make_audio_config(w2v_hf_dict(style)),
            text_config=c.DecoderConfig(
                vocab_size=384, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                rope_theta=500000.0, tie_word_embeddings=True,
            ),
            hidden_size=256,
            projector_ln_mid=True,
        )

    return mk(jc), mk(tc)


def make_w2v_params(jcfg, tcfg, lm_scale: float = 8.0):
    """(JAX params, the same values as port params), the projector's
    matrices scaled 2x and the decoder's ``lm_scale`` x, so that greedy
    tokens vary from step to step (the stable tower ends in a LayerNorm, so
    its outputs are O(1), larger than the Whisper fixture's)."""
    import jax

    from ultravox_torch.models.weights import from_jax_params
    from ultravox_tpu.models import ultravox as juv

    params = juv.init_params(jcfg, jax.random.key(0))
    scale = {"audio_tower": 1.0, "projector": 2.0, "language_model": lm_scale}
    params = {
        k: jax.tree.map(lambda a, f=scale[k]: a * f if a.ndim >= 2 else a, v)
        for k, v in params.items()
    }
    return params, from_jax_params(jax.tree.map(np.asarray, params), tcfg)
