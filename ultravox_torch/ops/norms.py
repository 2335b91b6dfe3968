"""Normalisation layers: fp32 internals, cast back to the input dtype."""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *, plus_one: bool = False
) -> torch.Tensor:
    """RMSNorm (HF LlamaRMSNorm semantics: variance in fp32, scale applied in
    fp32, cast back). ``plus_one`` is the Gemma ``(1 + w)`` convention."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    if plus_one:
        w = 1.0 + w
    return (xf * w).to(dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 internals (biased variance)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    out = xf * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
