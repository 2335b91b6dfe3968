"""Model configuration dataclasses (Whisper encoder, decoder LLM, composite).

The port's own copy of the configuration surface: the same field names and
defaults as the JAX package, so a configuration means the same model in both.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Dict, Optional, Tuple


class LossFunction(str, enum.Enum):
    CROSS_ENTROPY = "ce"
    KL_DIVERGENCE = "kl"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    loss_function: LossFunction = LossFunction.CROSS_ENTROPY
    kl_temperature: float = 2.0
    initial_tokens_to_ignore: int = 0
    eot_loss_weight: float = 1.0

    @property
    def requires_alt_fields(self) -> bool:
        return self.loss_function == LossFunction.KL_DIVERGENCE


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Low-rank adaptation config; ``r == 0`` means "freeze the model".
    ``unfreeze_layers`` are regex patterns of parameter paths to keep
    trainable when r == 0."""

    r: int = 0
    lora_alpha: float = 8.0
    target_modules: Tuple[str, ...] = ("k_proj", "q_proj", "linear_k", "linear_q")
    unfreeze_layers: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class WhisperEncoderConfig:
    """Whisper-style audio encoder (the subset of HF ``WhisperConfig`` used)."""

    num_mel_bins: int = 80
    d_model: int = 384
    num_layers: int = 4
    num_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500
    activation: str = "gelu"
    layerdrop: float = 0.0
    dropout: float = 0.0
    conv1_stride: int = 1
    conv2_stride: int = 2

    @property
    def downsample_factor(self) -> int:
        return self.conv1_stride * self.conv2_stride

    @property
    def max_context_length(self) -> int:
        """Max mel-frame input length."""
        return self.max_source_positions * self.downsample_factor

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "WhisperEncoderConfig":
        return cls(
            num_mel_bins=d.get("num_mel_bins", 80),
            d_model=d.get("d_model", 384),
            num_layers=d.get("encoder_layers", 4),
            num_heads=d.get("encoder_attention_heads", 6),
            ffn_dim=d.get("encoder_ffn_dim", 1536),
            max_source_positions=d.get("max_source_positions", 1500),
            activation=d.get("activation_function", "gelu"),
            layerdrop=d.get("encoder_layerdrop", 0.0),
            dropout=d.get("dropout", 0.0),
        )


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder-only text LLM. One dataclass with family flags covering the
    llama/mistral, gemma-2/3 and qwen-2/3 families, as in the JAX package."""

    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # Llama-3 rope scaling: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings); None = plain rope.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    sliding_window_pattern: Optional[int] = None
    layer_is_local: Optional[Tuple[bool, ...]] = None
    scale_embeddings: bool = False
    use_post_norms: bool = False
    final_logit_softcapping: Optional[float] = None
    attn_logit_softcapping: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    rope_local_base_freq: Optional[float] = None
    hidden_act: str = "silu"

    @property
    def attn_scale(self) -> float:
        if self.query_pre_attn_scalar is not None:
            return self.query_pre_attn_scalar**-0.5
        return self.head_dim**-0.5

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "DecoderConfig":
        model_type = d.get("model_type", "llama")
        if "text_config" in d and isinstance(d["text_config"], dict):
            inner = dict(d["text_config"])
            inner.setdefault("model_type", model_type.replace("_text", ""))
            d = inner
            model_type = d.get("model_type", model_type)
        arch = {
            "llama": "llama",
            "mistral": "mistral",
            "gemma2": "gemma2",
            "gemma3": "gemma3",
            "gemma3_text": "gemma3",
            "qwen2": "qwen2",
            "qwen3": "qwen3",
        }.get(model_type, "llama")
        num_heads = d.get("num_attention_heads", 32)
        hidden = d.get("hidden_size", 4096)
        sliding_window = d.get("sliding_window")
        sliding_window_pattern = d.get("sliding_window_pattern")
        layer_is_local = None
        if d.get("layer_types"):
            layer_is_local = tuple(
                t == "sliding_attention" for t in d["layer_types"]
            )
        elif arch == "gemma3" and sliding_window is not None and sliding_window_pattern is None:
            sliding_window_pattern = 6
        elif arch == "gemma2" and sliding_window is not None and sliding_window_pattern is None:
            sliding_window_pattern = 2
        rope_scaling = None
        rs = d.get("rope_scaling")
        if rs and rs.get("rope_type", rs.get("type")) == "llama3":
            rope_scaling = (
                float(rs["factor"]),
                float(rs["low_freq_factor"]),
                float(rs["high_freq_factor"]),
                int(rs["original_max_position_embeddings"]),
            )
        return cls(
            arch=arch,
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=hidden,
            intermediate_size=d.get("intermediate_size", 11008),
            num_layers=d.get("num_hidden_layers", 32),
            num_heads=num_heads,
            num_kv_heads=d.get("num_key_value_heads", num_heads),
            head_dim=d.get("head_dim") or hidden // num_heads,
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=rope_scaling,
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            attention_bias=d.get("attention_bias", False) or arch == "qwen2",
            qk_norm=arch in ("qwen3", "gemma3"),
            attn_logit_softcapping=d.get("attn_logit_softcapping"),
            sliding_window=sliding_window,
            sliding_window_pattern=sliding_window_pattern,
            layer_is_local=layer_is_local,
            scale_embeddings=arch in ("gemma2", "gemma3"),
            use_post_norms=arch in ("gemma2", "gemma3"),
            final_logit_softcapping=d.get("final_logit_softcapping"),
            query_pre_attn_scalar=d.get("query_pre_attn_scalar"),
            rope_local_base_freq=d.get("rope_local_base_freq"),
            hidden_act=d.get(
                "hidden_act",
                "gelu_pytorch_tanh" if arch in ("gemma2", "gemma3") else "silu",
            ),
        )


@dataclasses.dataclass(frozen=True)
class UltravoxConfig:
    """Composite speech-LLM config. The projector maps stacked encoder frames
    into the LLM embedding space: ``stack -> RMSNorm -> Linear -> SwiGLU ->
    [ln_mid] -> Linear -> [ln_post]``."""

    audio_config: WhisperEncoderConfig = dataclasses.field(
        default_factory=WhisperEncoderConfig
    )
    text_config: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    audio_model_id: Optional[str] = None
    text_model_id: Optional[str] = None
    llm_only_training: bool = False
    ignore_index: int = -100
    audio_token_index: Optional[int] = None
    hidden_size: int = 4096
    stack_factor: int = 8
    norm_init: float = 0.4
    projector_act: str = "swiglu"
    projector_ln_mid: bool = False
    audio_latency_block_size: Optional[int] = None

    @property
    def vocab_size(self) -> int:
        return self.text_config.vocab_size

    @property
    def audio_token_compression(self) -> int:
        """Mel frames consumed per LLM token: encoder downsample x stack."""
        return self.audio_config.downsample_factor * self.stack_factor

    @classmethod
    def from_hf_dict(cls, d: Dict[str, Any]) -> "UltravoxConfig":
        audio_cfg = d.get("audio_config") or {}
        if "wav2vec2" in (audio_cfg.get("model_type") or "whisper").lower():
            raise NotImplementedError("wav2vec2 audio towers are not ported yet")
        return cls(
            audio_config=WhisperEncoderConfig.from_hf_dict(audio_cfg),
            text_config=DecoderConfig.from_hf_dict(d.get("text_config") or {}),
            audio_model_id=d.get("audio_model_id"),
            text_model_id=d.get("text_model_id"),
            llm_only_training=d.get("llm_only_training", False),
            ignore_index=d.get("ignore_index", -100),
            audio_token_index=d.get("audio_token_index"),
            hidden_size=d.get("hidden_size", 4096),
            stack_factor=d.get("stack_factor", 8),
            norm_init=d.get("norm_init", 0.4),
            projector_act=d.get("projector_act", "swiglu"),
            projector_ln_mid=d.get("projector_ln_mid", False),
            audio_latency_block_size=d.get("audio_latency_block_size"),
        )

    @classmethod
    def from_json_file(cls, path: str) -> "UltravoxConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f))

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "UltravoxConfig":
        return cls.from_json_file(os.path.join(model_dir, "config.json"))
