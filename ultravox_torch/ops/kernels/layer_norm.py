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


# pieces a lane may hold in the warp-per-row kernel (csrc/layer_norm.cu
# dispatch_warp), by elements a piece: 8 bf16 or 4 fp32 (16 bytes), or 1
WARP_PIECES = {
    8: (1, 2, 3, 4, 6, 8, 12, 16),
    4: (1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
    1: (1, 2, 4, 8, 16, 32, 64, 128),
}
MAX_WARP_D = 4096  # past this a row keeps a block (and shared memory) of its own


def _plan(D: int, elem_size: int, ptrs) -> tuple:
    """(vec, pieces) of the kernel's instance for rows of D elements of
    ``elem_size`` bytes whose tensors start at ``ptrs``: one warp a row
    holding ``pieces`` 16-byte vectors a lane (vec), or elements when D or
    a pointer does not allow 16 bytes; pieces 0 is the block-per-row
    kernel, for D past MAX_WARP_D."""
    if D > MAX_WARP_D:
        return False, 0
    per = 16 // elem_size
    vec = D % per == 0 and all(p % 16 == 0 for p in ptrs)
    if not vec:
        per = 1
    need = -(-D // (32 * per))
    return vec, next(n for n in WARP_PIECES[per] if n >= need)


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
    vec, pieces = _plan(D, x.element_size(),
                        (x.data_ptr(), out.data_ptr(), scale32.data_ptr(), bias32.data_ptr()))
    lib = _build.library("layer_norm")
    rc = lib.uv_layer_norm(
        _build.ptr(x), _build.ptr(scale32), _build.ptr(bias32), _build.ptr(out),
        ctypes.c_longlong(rows), ctypes.c_int(D), ctypes.c_float(eps),
        ctypes.c_int(_build.dtype_code(x)), int(vec), pieces, _build.stream_ptr(x.device),
    )
    _build.check("layer_norm", rc)
    fused_layer_norm.launches += 1
    return out


fused_layer_norm.launches = 0
