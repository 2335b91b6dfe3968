"""LayerNorm kernel (``csrc/layer_norm.cu``) and its plain PyTorch version.

Replaces ``ultravox_tpu/ops/pallas/layer_norm.py:fused_layer_norm``: the
fused encoder's FFN LayerNorm. What bounds it on the card and how the
kernel meets that is noted at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from ultravox_torch.ops.kernels import _build


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis in the TPU kernel's order: fp32 mean,
    centred variance, ``(x - mean) * rsqrt(var + eps) * scale + bias``,
    cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def fused_layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis of x (any leading shape). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _build.require_cuda(x, scale, bias)
    D = x.shape[-1]
    if scale.shape != (D,) or bias.shape != (D,):
        raise ValueError(f"scale/bias must be ({D},), got {scale.shape}, {bias.shape}")
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    scale32 = scale.float().contiguous()
    bias32 = bias.float().contiguous()
    lib = _build.library("layer_norm")
    rc = lib.uv_layer_norm(
        _build.ptr(x), _build.ptr(scale32), _build.ptr(bias32), _build.ptr(out),
        ctypes.c_longlong(rows), ctypes.c_int(D), ctypes.c_float(eps),
        ctypes.c_int(_build.dtype_code(x)), _build.stream_ptr(x.device),
    )
    _build.check("layer_norm", rc)
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
