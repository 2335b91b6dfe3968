"""Checkpoint publishing: the full HF-layout export.

The counterpart of the pure parts of the JAX package's ``tools/publish.py``:
``save_pretrained`` writes a checkpoint directory (``config.json`` and
safetensors in the fixie naming scheme, plus tokenizer files when a
tokenizer is given) that ``inference.ultravox_infer.load_ultravox_checkpoint``
and the reference implementation load. The safetensors files are written by
``models.weights.save_safetensors``; no ``safetensors`` package is needed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from ultravox_torch import hub
from ultravox_torch.models import weights as weights_lib
from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.models.lora import merge_lora


def _audio_config_to_hf(cfg: UltravoxConfig) -> dict:
    audio = cfg.audio_config
    if cfg.audio_arch == "wav2vec2":
        return {
            "model_type": "wav2vec2",
            "_name_or_path": cfg.audio_model_id or "wav2vec2-encoder",
            "hidden_size": audio.hidden_size,
            "num_hidden_layers": audio.num_layers,
            "num_attention_heads": audio.num_heads,
            "intermediate_size": audio.ffn_dim,
            "conv_dim": list(audio.conv_dim),
            "conv_kernel": list(audio.conv_kernel),
            "conv_stride": list(audio.conv_stride),
            "conv_bias": audio.conv_bias,
            "feat_extract_norm": audio.feat_extract_norm,
            "do_stable_layer_norm": audio.do_stable_layer_norm,
            "num_conv_pos_embeddings": audio.num_conv_pos_embeddings,
            "num_conv_pos_embedding_groups": audio.num_conv_pos_embedding_groups,
            "layer_norm_eps": audio.layer_norm_eps,
        }
    return {
        "model_type": "whisper",
        # the reference selects its ModifiedWhisperEncoder path by
        # substring-matching _name_or_path
        "_name_or_path": cfg.audio_model_id or "whisper-encoder",
        "num_mel_bins": audio.num_mel_bins,
        "d_model": audio.d_model,
        "encoder_layers": audio.num_layers,
        "encoder_attention_heads": audio.num_heads,
        "encoder_ffn_dim": audio.ffn_dim,
        # decoder dims kept consistent so a full WhisperModel is also
        # constructible from this config
        "decoder_layers": audio.num_layers,
        "decoder_attention_heads": audio.num_heads,
        "decoder_ffn_dim": audio.ffn_dim,
        "max_source_positions": audio.max_source_positions,
        "activation_function": audio.activation,
    }


def config_to_hf_dict(cfg: UltravoxConfig) -> dict:
    return {
        "model_type": "ultravox",
        "audio_model_id": cfg.audio_model_id,
        "text_model_id": cfg.text_model_id,
        "ignore_index": cfg.ignore_index,
        "audio_token_index": cfg.audio_token_index,
        "hidden_size": cfg.hidden_size,
        "stack_factor": cfg.stack_factor,
        "norm_init": cfg.norm_init,
        "projector_act": cfg.projector_act,
        "projector_ln_mid": cfg.projector_ln_mid,
        "audio_latency_block_size": cfg.audio_latency_block_size,
        "llm_only_training": cfg.llm_only_training,
        "audio_config": _audio_config_to_hf(cfg),
        "text_config": _text_config_to_hf(cfg.text_config),
    }


def _text_config_to_hf(text) -> dict:
    """Full DecoderConfig -> HF config.json dict (everything
    ``DecoderConfig.from_hf_dict`` reads is written)."""
    out = {
        "model_type": text.arch if text.arch != "gemma3" else "gemma3_text",
        "vocab_size": text.vocab_size,
        "hidden_size": text.hidden_size,
        "intermediate_size": text.intermediate_size,
        "num_hidden_layers": text.num_layers,
        "num_attention_heads": text.num_heads,
        "num_key_value_heads": text.num_kv_heads,
        "head_dim": text.head_dim,
        "rms_norm_eps": text.rms_norm_eps,
        "rope_theta": text.rope_theta,
        "max_position_embeddings": text.max_position_embeddings,
        "tie_word_embeddings": text.tie_word_embeddings,
        "attention_bias": text.attention_bias,
        "hidden_act": text.hidden_act,
        "sliding_window": text.sliding_window,
        "sliding_window_pattern": text.sliding_window_pattern,
        "layer_types": (
            ["sliding_attention" if loc else "full_attention" for loc in text.layer_is_local]
            if text.layer_is_local is not None
            else None
        ),
        "query_pre_attn_scalar": text.query_pre_attn_scalar,
        "rope_local_base_freq": text.rope_local_base_freq,
        "final_logit_softcapping": text.final_logit_softcapping,
        "attn_logit_softcapping": text.attn_logit_softcapping,
    }
    if text.rope_scaling is not None:
        factor, low_ff, high_ff, orig_max = text.rope_scaling
        out["rope_scaling"] = {
            "rope_type": "llama3",
            "factor": factor,
            "low_freq_factor": low_ff,
            "high_freq_factor": high_ff,
            "original_max_position_embeddings": orig_max,
        }
    return out


def save_pretrained(
    params: Any,
    cfg: UltravoxConfig,
    out_dir: str,
    tokenizer=None,
    *,
    diff_only: bool = False,
    include_code: bool = False,
    dtype=torch.float32,
    shards: int = 1,
) -> str:
    """Write a loadable checkpoint directory. ``diff_only`` saves just the
    projector (adapter-sized, the reference's diff_state_dict semantics).
    LoRA adapters are merged into the kernels first. Tensors are written in
    ``dtype`` (fp32, as the reference writes; None keeps each leaf's
    dtype), in one file or ``shards`` files with an index.
    ``include_code`` also ships the standalone torch model code
    (``ultravox_torch/hub``) with ``auto_map`` entries in ``config.json``,
    so the directory loads with ``AutoModel.from_pretrained(dir,
    trust_remote_code=True)`` where only ``transformers`` is installed."""
    params = merge_lora(params)
    os.makedirs(out_dir, exist_ok=True)
    hf_dict = config_to_hf_dict(cfg)
    if include_code:
        hf_dict["auto_map"] = dict(hub.AUTO_MAP)
        for fname in hub.HUB_CODE_FILES:
            shutil.copyfile(os.path.join(hub.HUB_CODE_DIR, fname + hub.STORED_SUFFIX),
                            os.path.join(out_dir, fname))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_dict, f, indent=2)

    sd: dict = {}
    if "projector" in params:
        for k, v in weights_lib.projector_to_hf(params["projector"], dtype).items():
            sd[f"multi_modal_projector.{k}"] = v
    if not diff_only:
        if "language_model" in params:
            for k, v in weights_lib.decoder_to_hf(
                params["language_model"], cfg.text_config, dtype
            ).items():
                sd[f"language_model.{k}"] = v
        if "audio_tower" in params:
            enc_to_hf = _wav2vec2_to_hf if cfg.audio_arch == "wav2vec2" else _encoder_to_hf
            for k, v in enc_to_hf(params["audio_tower"], cfg, dtype).items():
                sd[f"audio_tower.{k}"] = v
    weights_lib.save_safetensors_dir(sd, out_dir, shards)
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
    return out_dir


def _encoder_to_hf(params: Any, cfg: UltravoxConfig, dtype=torch.float32) -> dict:
    """Whisper encoder tree -> HF WhisperEncoder state dict."""
    out = {}
    L = cfg.audio_config.num_layers
    hf = weights_lib._hf

    def unstack(pattern, arr, transpose=False):
        a = hf(arr, dtype)
        for i in range(L):
            out[pattern.format(i=i)] = a[i].T if transpose else a[i]

    for conv in ("conv1", "conv2"):
        out[f"{conv}.weight"] = hf(params[conv]["kernel"], dtype).permute(2, 1, 0)
        out[f"{conv}.bias"] = hf(params[conv]["bias"], dtype)
    out["embed_positions.weight"] = hf(params["embed_positions"], dtype)
    out["layer_norm.weight"] = hf(params["layer_norm"]["scale"], dtype)
    out["layer_norm.bias"] = hf(params["layer_norm"]["bias"], dtype)
    ly = params["layers"]
    for name, mine, bias in [
        ("self_attn.q_proj", "q_proj", True),
        ("self_attn.k_proj", "k_proj", False),
        ("self_attn.v_proj", "v_proj", True),
        ("self_attn.out_proj", "out_proj", True),
        ("fc1", "fc1", True),
        ("fc2", "fc2", True),
    ]:
        unstack("layers.{i}." + name + ".weight", ly[mine]["kernel"], transpose=True)
        if bias:
            unstack("layers.{i}." + name + ".bias", ly[mine]["bias"])
    for name, mine in [("self_attn_layer_norm", "attn_ln"), ("final_layer_norm", "final_ln")]:
        unstack("layers.{i}." + name + ".weight", ly[mine]["scale"])
        unstack("layers.{i}." + name + ".bias", ly[mine]["bias"])
    return out


def _wav2vec2_to_hf(params: Any, cfg: UltravoxConfig, dtype=torch.float32) -> dict:
    """wav2vec2 tower tree -> HF Wav2Vec2Model state dict, the reverse of
    ``weights.convert_wav2vec2_encoder``. The weight-normalised positional
    conv is written as weight_v = kernel and weight_g = ||kernel|| over
    dims (0, 1) (taken in float64), both in fp32 at least, so g * v / ||v||
    gives the kernel back (bit for bit once cast back to bf16)."""
    out = {}
    hf = weights_lib._hf
    for i, conv in enumerate(params["feature_extractor"]):
        stem = f"feature_extractor.conv_layers.{i}"
        out[f"{stem}.conv.weight"] = hf(conv["kernel"], dtype).permute(2, 1, 0)
        if "bias" in conv:
            out[f"{stem}.conv.bias"] = hf(conv["bias"], dtype)
        if "norm" in conv:
            out[f"{stem}.layer_norm.weight"] = hf(conv["norm"]["scale"], dtype)
            out[f"{stem}.layer_norm.bias"] = hf(conv["norm"]["bias"], dtype)
    fp = params["feature_projection"]
    out["feature_projection.layer_norm.weight"] = hf(fp["ln"]["scale"], dtype)
    out["feature_projection.layer_norm.bias"] = hf(fp["ln"]["bias"], dtype)
    out["feature_projection.projection.weight"] = hf(fp["projection"]["kernel"], dtype).T
    out["feature_projection.projection.bias"] = hf(fp["projection"]["bias"], dtype)
    # the pair in fp32 at least: a bf16 g would round the kernel it rebuilds
    pos_kernel = hf(params["pos_conv"]["kernel"], dtype).permute(2, 1, 0)
    pos_kernel = pos_kernel.to(torch.promote_types(pos_kernel.dtype, torch.float32))
    norm = pos_kernel.double().square().sum(dim=(0, 1), keepdim=True).sqrt()
    out["encoder.pos_conv_embed.conv.weight_v"] = pos_kernel
    out["encoder.pos_conv_embed.conv.weight_g"] = norm.to(pos_kernel.dtype)
    out["encoder.pos_conv_embed.conv.bias"] = hf(params["pos_conv"]["bias"], dtype)
    out["encoder.layer_norm.weight"] = hf(params["encoder_ln"]["scale"], dtype)
    out["encoder.layer_norm.bias"] = hf(params["encoder_ln"]["bias"], dtype)
    L = cfg.audio_config.num_layers

    def unstack(pattern, arr, transpose=False):
        a = hf(arr, dtype)
        for i in range(L):
            out[pattern.format(i=i)] = a[i].T if transpose else a[i]

    ly = params["layers"]
    for name, mine in [
        ("attention.q_proj", "q_proj"), ("attention.k_proj", "k_proj"),
        ("attention.v_proj", "v_proj"), ("attention.out_proj", "out_proj"),
        ("feed_forward.intermediate_dense", "fc1"), ("feed_forward.output_dense", "fc2"),
    ]:
        unstack("encoder.layers.{i}." + name + ".weight", ly[mine]["kernel"], transpose=True)
        unstack("encoder.layers.{i}." + name + ".bias", ly[mine]["bias"])
    for name, mine in [("layer_norm", "attn_ln"), ("final_layer_norm", "final_ln")]:
        unstack("encoder.layers.{i}." + name + ".weight", ly[mine]["scale"])
        unstack("encoder.layers.{i}." + name + ".bias", ly[mine]["bias"])
    return out
