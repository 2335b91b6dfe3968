"""Segmented decode attention kernel (``csrc/segment_attention.cu``) and its
plain version.

``segment_tail_attention`` replaces ``ultravox_tpu/ops/pallas/
segment_attention.py:segment_tail_attention``: T queries per row against the
stacked (L, B, S, Hkv, D) prompt cache at a runtime ``layer`` plus a carried
(B, Ts, Hkv, D) tail. Query t sits at absolute position
q_abs = n + written + t (n = ``lengths[b]``):

    prompt key j visible  iff  j < n and (window <= 0 or q_abs - j < window)
    tail slot s visible   iff  s <= written + t and
                               (window <= 0 or q_abs - (n + s) < window)

``paged_segment_tail_attention`` replaces ``segment_attention.py:
paged_segment_tail_attention``: the same with the prompt segment in the
stacked (L, P, page_size, Hkv, D) pool at ``layer``, through a (B, n_per)
int32 page table whose ids clamp to [0, P - 1].

On the card both are bound by their chain of dependent loads, not by bytes.
Both run ``csrc/kv_split.cuh``'s kernel, each as its own ``__global__`` of
``csrc/segment_attention.cu``: a cluster of ``kv_splits(S + Ts)`` blocks
(``kv_splits(n_per * page_size + Ts)`` paged) splits each row's visible
keys, and the paged instance loads each key step's page ids a step ahead of
its K/V so no load waits on the table. The plain versions with
``softmax=split_softmax_plain`` emulate the split and merge.

Each wrapper takes its plain version for CPU tensors and launches its kernel
for CUDA tensors; ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels.decode_attention import (
    HEAD_DIMS,
    check_kv_aligned,
    kv_splits,
    online_softmax_plain,
    rounded_scale,
)
from ultravox_torch.ops.kernels.paged_attention import gather_pages_plain


def segment_tail_attention_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k_cache: torch.Tensor,  # (L, B, S, Hkv, D) or (B, S, Hkv, D)
    v_cache: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,  # (B,) prompt length
    tail_k: torch.Tensor,  # (B, Ts, Hkv, D)
    tail_v: torch.Tensor,
    written: torch.Tensor,  # (B,) tail slots filled before these queries
    window: int = 0,
    *,
    scale: float,
    softmax: Callable = online_softmax_plain,
) -> torch.Tensor:
    """Plain PyTorch in the kernel's arithmetic. Returns (B, T, H, D).
    ``softmax`` as ``decode_attention_plain``'s."""
    if k_cache.ndim == 5:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    Ts = tail_k.shape[1]
    G = H // Hkv
    dev = q.device
    qs = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, T, Hkv, G, D).float()
    n = lengths.to(dev).long()[:, None, None]  # (B, 1, 1)
    wr = written.to(dev).long()[:, None, None]
    t = torch.arange(T, device=dev)[None, :, None]  # (1, T, 1)
    q_abs = n + wr + t  # (B, T, 1)
    kpos = torch.arange(S, device=dev)[None, None, :]
    slot = torch.arange(Ts, device=dev)[None, None, :]
    ok_p = kpos < n  # (B, T, S)
    ok_t = slot <= wr + t  # (B, T, Ts)
    if window > 0:
        ok_p = ok_p & (q_abs - kpos < window)
        ok_t = ok_t & (q_abs - (n + slot) < window)
    segments = []
    for keys, vals, ok in ((k_cache, v_cache, ok_p), (tail_k, tail_v, ok_t)):
        s = torch.einsum("btkgd,bskd->bkgts", qs, keys.float())  # (B, Hkv, G, T, S*)
        v = vals.float().permute(0, 2, 1, 3)[:, :, None, None]  # (B, Hkv, 1, 1, S*, D)
        segments.append((s, ok[:, None, None], v))
    out = softmax(segments, q.dtype)  # (B, Hkv, G, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def segment_tail_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k_cache: torch.Tensor,  # (L, B, S, Hkv, D) stacked, or (B, S, Hkv, D) with layer 0
    v_cache: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,  # (B,) int32 prompt length
    tail_k: torch.Tensor,  # (B, Ts, Hkv, D)
    tail_v: torch.Tensor,
    written: torch.Tensor,  # (B,) int32
    window: int = 0,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """T-query attention over the prompt cache at ``layer`` plus the tail.
    Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    if q.device.type == "cpu":
        return segment_tail_attention_plain(
            q, k_cache, v_cache, layer, lengths, tail_k, tail_v, written, window, scale=scale
        )
    _build.require_cuda(q, k_cache, v_cache, lengths, tail_k, tail_v, written)
    kc, vc = (k_cache, v_cache) if k_cache.ndim == 5 else (k_cache[None], v_cache[None])
    L, _, S, Hkv, _ = kc.shape
    Ts = tail_k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if (kc.shape != (L, B, S, Hkv, D) or vc.shape != kc.shape or H % Hkv
            or tail_k.shape != (B, Ts, Hkv, D) or tail_v.shape != tail_k.shape):
        raise ValueError(
            f"bad shapes for segment_tail_attention: q {q.shape}, cache {k_cache.shape}, "
            f"tail {tail_k.shape}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the cache's {L} layers")
    if not (q.dtype == kc.dtype == vc.dtype == tail_k.dtype == tail_v.dtype):
        raise TypeError("q, the cache and the tail must share one dtype")
    if (q.stride(-1) != 1 or kc.stride(-1) != 1 or tail_k.stride(-1) != 1
            or kc.stride() != vc.stride() or tail_k.stride() != tail_v.stride()):
        raise ValueError("head dims must be contiguous; k and v must share strides")
    for t in (lengths, written):
        if t.shape != (B,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"lengths and written must be contiguous int32 ({B},) tensors")
    check_kv_aligned("segment_tail_attention", kc, vc, tail_k, tail_v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:3], *kc.stride()[:4], *tail_k.stride()[:3]
    )
    lib = _build.library("segment_attention")
    rc = lib.uv_segment_attention(
        _build.ptr(q), _build.ptr(kc), _build.ptr(vc), _build.ptr(tail_k), _build.ptr(tail_v),
        _build.ptr(out), strides, _build.ptr(lengths), _build.ptr(written), int(layer),
        int(window), B, T, H, H // Hkv, S, Ts, D, rounded_scale(scale, q.dtype),
        kv_splits(S + Ts), _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("segment_attention", rc)
    segment_tail_attention.launches += 1
    return out


segment_tail_attention.launches = 0


def paged_segment_tail_attention_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k_pool: torch.Tensor,  # (L, P, ps, Hkv, D)
    v_pool: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # (B, n_per) int32
    lengths: torch.Tensor,  # (B,) prompt length
    tail_k: torch.Tensor,  # (B, Ts, Hkv, D)
    tail_v: torch.Tensor,
    written: torch.Tensor,  # (B,)
    window: int = 0,
    *,
    scale: float,
    softmax: Callable = online_softmax_plain,
) -> torch.Tensor:
    """Plain PyTorch: the clamped page gather of ``layer``, then
    ``segment_tail_attention_plain`` (``softmax`` as its). Returns
    (B, T, H, D)."""
    k = gather_pages_plain(k_pool[layer], page_table)
    v = gather_pages_plain(v_pool[layer], page_table)
    return segment_tail_attention_plain(
        q, k, v, 0, lengths, tail_k, tail_v, written, window, scale=scale, softmax=softmax
    )


def paged_segment_tail_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k_pool: torch.Tensor,  # (L, P, ps, Hkv, D) stacked pool
    v_pool: torch.Tensor,
    layer: int,
    page_table: torch.Tensor,  # (B, n_per) int32
    lengths: torch.Tensor,  # (B,) int32 prompt length
    tail_k: torch.Tensor,  # (B, Ts, Hkv, D)
    tail_v: torch.Tensor,
    written: torch.Tensor,  # (B,) int32
    window: int = 0,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """T-query attention over row b's pool pages at ``layer`` plus the tail.
    Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    if q.device.type == "cpu":
        return paged_segment_tail_attention_plain(
            q, k_pool, v_pool, layer, page_table, lengths, tail_k, tail_v, written, window,
            scale=scale,
        )
    _build.require_cuda(q, k_pool, v_pool, page_table, lengths, tail_k, tail_v, written)
    L, P, ps, Hkv, _ = k_pool.shape
    n_per = page_table.shape[1]
    Ts = tail_k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if (k_pool.shape != (L, P, ps, Hkv, D) or v_pool.shape != k_pool.shape or H % Hkv
            or tail_k.shape != (B, Ts, Hkv, D) or tail_v.shape != tail_k.shape
            or page_table.shape != (B, n_per)):
        raise ValueError(
            f"bad shapes for paged_segment_tail_attention: q {q.shape}, pool {k_pool.shape}, "
            f"table {page_table.shape}, tail {tail_k.shape}")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside the pool's {L} layers")
    if not (q.dtype == k_pool.dtype == v_pool.dtype == tail_k.dtype == tail_v.dtype):
        raise TypeError("q, the pool and the tail must share one dtype")
    if (q.stride(-1) != 1 or k_pool.stride(-1) != 1 or tail_k.stride(-1) != 1
            or k_pool.stride() != v_pool.stride() or tail_k.stride() != tail_v.stride()):
        raise ValueError("head dims must be contiguous; k and v must share strides")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise TypeError("page_table must be a contiguous int32 tensor")
    for t in (lengths, written):
        if t.shape != (B,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"lengths and written must be contiguous int32 ({B},) tensors")
    check_kv_aligned("paged_segment_tail_attention", k_pool, v_pool, tail_k, tail_v)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:3], *k_pool.stride()[:4], *tail_k.stride()[:3]
    )
    lib = _build.library("segment_attention")
    rc = lib.uv_paged_segment_attention(
        _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(tail_k),
        _build.ptr(tail_v), _build.ptr(out), strides, _build.ptr(page_table),
        _build.ptr(lengths), _build.ptr(written), int(layer), int(window), B, T, H, H // Hkv,
        n_per, ps, P, Ts, D, rounded_scale(scale, q.dtype), kv_splits(n_per * ps + Ts),
        _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("segment_attention", rc)
    paged_segment_tail_attention.launches += 1
    return out


paged_segment_tail_attention.launches = 0
