"""Paged decode attention kernel (``csrc/paged_attention.cu``) and its plain
version.

``paged_decode_attention`` replaces ``ultravox_tpu/ops/pallas/
paged_attention.py:paged_decode_attention``: one query per row against one
layer's (P, page_size, Hkv, D) pool through a (B, n_per) int32 page table,
keys in [max(n - window, 0), n) (all of [0, n) when window <= 0), GQA. Page
ids clamp to [0, P - 1], so sentinel entries read finite pool data. The
wrapper takes its plain version for CPU tensors and launches the kernel for
CUDA tensors; ``paged_decode_attention.launches`` counts kernel launches.

On the card the kernel is bound by its chain of dependent loads, not by
bytes: it is the paged instance of ``decode_attention``'s split kernel
(``csrc/kv_split.cuh``), a cluster of ``kv_splits(n_per * page_size)``
blocks per row and kv head, with each key step's page ids loaded a step
ahead of its K/V so no load waits on the table. The plain version with
``softmax=split_softmax_plain`` emulates its split and merge.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels.decode_attention import (
    HEAD_DIMS,
    check_kv_aligned,
    decode_attention_plain,
    kv_splits,
    online_softmax_plain,
    rounded_scale,
)


def gather_pages_plain(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(..., P, ps, Hkv, D) pool -> (..., B, n_per * ps, Hkv, D): each row's
    pages in table order, ids clamped to [0, P - 1]."""
    P, ps, Hkv, D = pool.shape[-4:]
    B, n_per = page_table.shape
    ids = page_table.to(pool.device).long().clamp(0, P - 1).reshape(-1)
    out = torch.index_select(pool, pool.ndim - 4, ids)
    return out.reshape(*pool.shape[:-4], B, n_per * ps, Hkv, D)


def paged_decode_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    k_pool: torch.Tensor,  # (P, ps, Hkv, D)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_per) int32
    lengths: torch.Tensor,  # (B,) valid entries, the current token included
    window: int = 0,
    *,
    scale: float,
    softmax: Callable = online_softmax_plain,
) -> torch.Tensor:
    """Plain PyTorch: the clamped page gather, then the kernel arithmetic
    (``decode_attention_plain``, ``softmax`` as its). Returns (B, H, D)."""
    k = gather_pages_plain(k_pool, page_table)
    v = gather_pages_plain(v_pool, page_table)
    return decode_attention_plain(q, k, v, lengths, window, scale=scale, softmax=softmax)


def paged_decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_pool: torch.Tensor,  # (P, ps, Hkv, D); the head dim contiguous
    v_pool: torch.Tensor,  # (P, ps, Hkv, D), at k_pool's strides
    page_table: torch.Tensor,  # (B, n_per) int32
    lengths: torch.Tensor,  # (B,) int32 valid entries
    window: int = 0,  # sliding window; 0 = none
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention over a paged pool. Returns (B, H, D) in
    q's dtype."""
    B, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, page_table, lengths, window, scale=scale
        )
    _build.require_cuda(q, k_pool, v_pool, page_table, lengths)
    P, ps, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    n_per = page_table.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if (k_pool.shape != (P, ps, Hkv, D) or v_pool.shape != k_pool.shape or H % Hkv
            or page_table.shape != (B, n_per)):
        raise ValueError(
            f"bad shapes for paged_decode_attention: q {q.shape}, pool {k_pool.shape}, "
            f"table {page_table.shape}")
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise TypeError("q and the pool must share one dtype")
    if q.stride(-1) != 1 or k_pool.stride(-1) != 1 or k_pool.stride() != v_pool.stride():
        raise ValueError("the head dim must be contiguous and k, v must share strides")
    for t, name in ((page_table, "page_table"), (lengths, "lengths")):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous int32 tensor")
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},)")
    check_kv_aligned("paged_decode_attention", k_pool, v_pool)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 5)(q.stride(0), q.stride(1), *k_pool.stride()[:3])
    lib = _build.library("paged_attention")
    rc = lib.uv_paged_attention(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(out), strides,
        _build.ptr(page_table), _build.ptr(lengths), int(window), B, H, H // Hkv, n_per, ps, P,
        D, rounded_scale(scale, q.dtype), kv_splits(n_per * ps), _build.dtype_code(q),
        _build.stream_ptr(q.device),
    )
    _build.check("paged_attention", rc)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
