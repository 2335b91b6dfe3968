"""Skinny matrix product for decode steps, with its plain version.

``decode_matmul`` (``csrc/decode_matmul.cu``) replaces
``ultravox_tpu/ops/pallas/decode_matmul.py:decode_matmul``: x (M <= 32, K)
in bf16 or fp32 times w (K, N) in bf16 or int8, the weight cast to x's
dtype (exact), fp32 sums, an optional per-output-channel ``scale`` applied
to the sums, then the cast to ``out_dtype`` (default x's). That is the
w8a16 product of ``models/lora.py`` (``(x @ wq) * scale``, then the cast),
read from the int8 weight directly instead of from a bf16 copy of it. Like
the reference, nothing in the port calls it yet.

The wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors (``decode_matmul.launches`` counts calls; a call that
splits K launches a second kernel that adds the splits).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ultravox_torch.ops.kernels import _build

MAX_ROWS = 32
SUM_ROWS = (1, 4, 8, 16, 32)  # row counts the kernel keeps sums for
MAX_SUMS = 32  # fp32 sums per lane: rows x columns
W_CODES = {torch.bfloat16: 1, torch.int8: 2}  # csrc/decode_matmul.cu
MIN_SPLIT_ROWS = 128  # rows of K a block streams at least when K is split


def decode_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None, out_dtype=None
) -> torch.Tensor:
    acc = x.float() @ w.to(x.dtype).float()
    if scale is not None:
        acc = acc * scale.reshape(-1).float()
    return acc.to(out_dtype or x.dtype)


def supports(x_shape, k: int, n: int) -> bool:
    """The reference's gate for routing a product here: decode-shaped (at
    most 32 rows), 128-aligned contraction and output dims, and the
    activation block within 2 MB. The card's kernel itself takes any K and
    N; the gate is kept as the reference wrote it for the code that will
    route products by it."""
    if len(x_shape) < 2:
        return False
    rows = 1
    for d in x_shape[:-1]:
        rows *= d
    return rows <= 32 and k % 128 == 0 and n % 128 == 0 and rows * k * 4 <= 2 * 1024 * 1024


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(M: int, K: int, N: int, w: torch.Tensor, sms: int):
    """(sum rows, columns per lane, K splits, rows per split). A lane loads
    its columns as one vector of at most 16 bytes and keeps at most 32 sums;
    a ragged N or an unaligned weight falls to one column per lane. K is
    split so that the grid fills whole waves of two blocks per SM (a last
    wave a fraction full costs as much as a full one)."""
    mt = next(t for t in SUM_ROWS if M <= t)
    cpt = min(16 // w.element_size(), MAX_SUMS // mt)
    if N % cpt or w.data_ptr() % (cpt * w.element_size()):
        cpt = 1
    tiles = -(-N // (32 * cpt))
    splits = max(1, min(2 * sms // tiles, K // MIN_SPLIT_ROWS))
    k_split = -(-K // splits)
    return mt, cpt, -(-K // k_split), k_split


def decode_matmul(
    x: torch.Tensor,  # (M, K), M <= 32, bf16 or fp32
    w: torch.Tensor,  # (K, N), bf16 or int8
    scale: Optional[torch.Tensor] = None,  # N per-output-channel values
    *,
    out_dtype=None,
) -> torch.Tensor:
    """x @ w (times scale), the weight streamed once. Returns (M, N)."""
    if x.device.type == "cpu":
        return decode_matmul_plain(x, w, scale, out_dtype)
    _build.require_cuda(x, w, scale)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"decode_matmul takes (M, K) x (K, N), got {x.shape} x {w.shape}")
    M, K = x.shape
    N = w.shape[1]
    if not 1 <= M <= MAX_ROWS or K == 0 or N == 0:
        raise ValueError(f"decode_matmul takes 1 to {MAX_ROWS} rows and a non-empty weight, "
                         f"got {x.shape} x {w.shape}")
    if w.dtype not in W_CODES:
        raise TypeError(f"decode_matmul takes a bf16 or int8 weight, got {w.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"decode_matmul writes fp32 or bf16, not {out_dtype}")
    if x.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("decode_matmul takes x with contiguous rows and a contiguous weight")
    scale_code = -1
    if scale is not None:
        if scale.numel() != N or not scale.is_contiguous():
            raise ValueError(f"scale must be {N} contiguous values, got {tuple(scale.shape)}")
        scale_code = _build.dtype_code(scale)
    mt, cpt, splits, k_split = _plan(M, K, N, w, _sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.library("decode_matmul")
    rc = lib.uv_decode_matmul(
        _build.ptr(x), x.stride(0), _build.dtype_code(x), _build.ptr(w), W_CODES[w.dtype],
        _build.ptr(scale), scale_code, _build.ptr(out), _build.DTYPE_CODES[out_dtype],
        _build.ptr(partial), M, K, N, mt, cpt, splits, k_split, _build.stream_ptr(x.device),
    )
    _build.check("decode_matmul", rc)
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0
