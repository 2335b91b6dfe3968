"""Audio -> text projector: ``stack -> RMSNorm(ln_pre) -> Linear -> SwiGLU
-> [RMSNorm(ln_mid)] -> Linear -> [RMSNorm(ln_post)]``, biasless linears.
SwiGLU takes the first half as the value and the second as the gate."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ultravox_torch.models.config import UltravoxConfig
from ultravox_torch.ops.norms import rms_norm
from ultravox_torch.parallel.sharding import gather_whole

Params = Dict[str, Any]


def stack_audio_frames(x: torch.Tensor, stack_factor: int) -> torch.Tensor:
    """(B, T, C) -> (B, ceil(T / S), C * S), zero-padding T."""
    B, T, C = x.shape
    T_pad = (T + stack_factor - 1) // stack_factor * stack_factor
    x = F.pad(x, (0, 0, 0, T_pad - T))
    return x.reshape(B, T_pad // stack_factor, C * stack_factor)


def init_params(
    cfg: UltravoxConfig, generator: torch.Generator, dtype=torch.float32, device=None
) -> Params:
    dim_in = cfg.audio_config.d_model * cfg.stack_factor
    hidden = cfg.hidden_size
    dim_mid = hidden // 2 if cfg.projector_act == "swiglu" else hidden
    dim_out = cfg.text_config.hidden_size

    def lin(fi, fo):  # torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        u = torch.rand((fi, fo), generator=generator, device=device, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * fi**-0.5).to(dtype)

    params: Params = {
        "ln_pre": torch.full((dim_in,), cfg.norm_init, dtype=dtype, device=device),
        "linear_1": {"kernel": lin(dim_in, hidden)},
        "linear_2": {"kernel": lin(dim_mid, dim_out)},
    }
    if cfg.projector_ln_mid:
        params["ln_mid"] = torch.full((dim_mid,), cfg.norm_init, dtype=dtype, device=device)
    else:
        params["ln_post"] = torch.full((dim_out,), cfg.norm_init, dtype=dtype, device=device)
    return params


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype, as JAX promotes a bf16 x fp32 product
    (an int8 tree's bf16 encoder states meet fp32 projector weights)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def projector_forward(params: Params, cfg: UltravoxConfig, audio_features: torch.Tensor) -> torch.Tensor:
    """(B, T_enc, C) encoder states -> (B, ceil(T_enc / S), D_text). The
    kernels are read whole (gathered over fsdp and ``tensor``): SwiGLU
    halves ``linear_1``'s output and ``ln_mid`` normalises all of it, so a
    column split of it would not hold a rank's own units."""
    x = stack_audio_frames(audio_features, cfg.stack_factor)
    x = rms_norm(x, params["ln_pre"])
    x = _matmul(x, gather_whole(params["linear_1"]["kernel"]))
    if cfg.projector_act == "swiglu":
        val, gate = x.chunk(2, dim=-1)
        x = F.silu(gate) * val
    elif cfg.projector_act == "silu":
        x = F.silu(x)
    elif cfg.projector_act == "gelu":
        x = F.gelu(x)
    else:
        raise ValueError(f"unsupported projector_act {cfg.projector_act}")
    if "ln_mid" in params:
        x = rms_norm(x, params["ln_mid"])
    x = _matmul(x, gather_whole(params["linear_2"]["kernel"]))
    if "ln_post" in params:
        x = rms_norm(x, params["ln_post"])
    return x


def num_audio_tokens(mel_len, compression: int):
    """ceil(mel_len / (encoder downsample x stack)): LLM positions per chunk."""
    return -(-mel_len // compression)
