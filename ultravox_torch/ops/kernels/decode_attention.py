"""Decode attention kernel (``csrc/decode_attention.cu``) and its plain version.

``decode_attention`` replaces ``ultravox_tpu/ops/pallas/decode_attention.py:
decode_attention``: one query per row against a (B, S, Hkv, D) cache slab,
keys in [max(n - window, 0), n) (all of [0, n) when window <= 0), GQA. The
wrapper takes its plain version for CPU tensors and launches the kernel for
CUDA tensors; ``decode_attention.launches`` counts kernel launches.

The kernel (``csrc/kv_split.cuh``, shared with ``segment_tail_attention``
and, in its paged instances, with ``paged_decode_attention`` and
``paged_segment_tail_attention``) splits each row's visible keys across a
cluster of ``kv_splits(S)`` blocks and merges their partial softmax states
in rank order.
``split_softmax_plain`` emulates that split and merge in plain PyTorch; the
tests hold it against the TPU kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Tuple

import torch

from ultravox_torch.ops.attention import NEG_INF
from ultravox_torch.ops.kernels import _build

HEAD_DIMS = (64, 128)  # head dims the kernel is instantiated for
VEC_BYTES = 16  # the split kernel loads 16 bytes of a K or V row per lane
MAX_SPLITS = 8  # blocks of a cluster (the portable cluster size)
SPLIT_KEYS = 32  # keys one block reads per step (bf16, D = 64)
SPLIT_GRANULE = 16  # each rank's share of the keys is a multiple of this


def kv_splits(n_keys: int) -> int:
    """Blocks of the cluster that splits a row's keys: the least power of
    two, at most MAX_SPLITS, that leaves each block at most SPLIT_KEYS of the
    ``n_keys`` slots a row may see (S, or S + Ts with a tail). Chosen from
    the slab size, never from the lengths, which live on the card."""
    ns = 1
    while ns < MAX_SPLITS and ns * SPLIT_KEYS < n_keys:
        ns *= 2
    return ns


def check_kv_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The split kernel loads 16-byte pieces of K and V rows: each base
    pointer and each stride in bytes must be a multiple of 16 (the head dim,
    64 or 128, always is). Raises ValueError otherwise."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % VEC_BYTES or any(s * size % VEC_BYTES for s in t.stride()[:-1]):
            raise ValueError(
                f"{name}: the cache and the tail must start on a {VEC_BYTES}-byte boundary "
                f"and have strides that are multiples of {VEC_BYTES} bytes (a view at element "
                f"offset {t.storage_offset()} with strides {t.stride()} does not)")


@functools.lru_cache(maxsize=None)
def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` as the TPU kernels apply it: rounded to the query's dtype."""
    return float(torch.tensor(scale, dtype=dtype))


Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # softmax state (m, z, acc)


def softmax_state(segments) -> Partial:
    """The running max m, sum z and accumulator acc of a softmax over key
    segments. Each segment is (logits (..., S) fp32, visible (..., S) bool,
    values (..., S, D) fp32). Hidden logits take NEG_INF and probability 0;
    the probabilities stay fp32 into the PV product. No visible key gives
    m = NEG_INF, z = 0, acc = 0."""
    m = None
    for s, ok, _ in segments:
        sm = s.masked_fill(~ok, NEG_INF).amax(dim=-1, keepdim=True)
        m = sm if m is None else torch.maximum(m, sm)
    z, acc = 0.0, 0.0
    for s, ok, v in segments:
        e = torch.where(ok, torch.exp(s - m), torch.zeros((), device=s.device))
        z = z + e.sum(dim=-1, keepdim=True)
        acc = acc + torch.matmul(e[..., None, :], v)[..., 0, :]
    return m, z, acc


def online_softmax_plain(segments, q_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' softmax over key segments (``softmax_state``'s) without
    concatenating them; the output is acc / max(z, 1e-30) in ``q_dtype``."""
    _, z, acc = softmax_state(segments)
    return (acc / torch.clamp(z, min=1e-30)).to(q_dtype)


def key_ranks(masks, ns: int, granule: int = SPLIT_GRANULE) -> List[torch.Tensor]:
    """The rank that reads each key, per row: (B, S_i) int64 per visibility
    mask (the row on dim 0, the key on the last dim), -1 where no query of
    the row sees the key."""
    seen = [ok.flatten(1, -2).any(1) for ok in masks]  # (B, S_i) each
    cat = torch.cat(seen, dim=-1)
    per = -(-cat.sum(dim=-1, keepdim=True) // ns)  # ceil(N / ns)
    share = torch.clamp(-(-per // granule) * granule, min=1)
    rank = torch.where(cat, (torch.cumsum(cat, dim=-1) - 1) // share, -1)
    return list(torch.split(rank, [x.shape[-1] for x in seen], dim=-1))


def rank_partials_plain(segments, ns: int, granule: int = SPLIT_GRANULE) -> List[Partial]:
    """The split kernel's partial softmax state (m, z, acc) of each of ``ns``
    ranks. ``segments`` as ``online_softmax_plain``'s, with the row (batch)
    on dim 0 and the key on the last dim of each visibility mask. A row's
    keys that some query sees, segment after segment, form one virtual
    range of N keys; rank r takes [r * share, (r + 1) * share) of it, share
    = ceil(N / ns) rounded up to ``granule``. A rank with no keys has m =
    NEG_INF, z = 0, acc = 0."""
    ranks = key_ranks([ok for _, ok, _ in segments], ns, granule)
    return [
        softmax_state([
            (s, ok & (rk == r).reshape(rk.shape[0], *[1] * (ok.ndim - 2), rk.shape[-1]), v)
            for (s, ok, v), rk in zip(segments, ranks)
        ])
        for r in range(ns)
    ]


def merge_partials_plain(parts: List[Partial], q_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's merge of the ranks' partial states, in rank order:
    m = max m_i, z = sum z_i exp(m_i - m), acc likewise; the output is
    acc / max(z, 1e-30) in ``q_dtype``."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    z, acc = 0.0, 0.0
    for mi, zi, ai in parts:
        f = torch.exp(mi - m)
        z = z + zi * f
        acc = acc + ai * f
    return (acc / torch.clamp(z, min=1e-30)).to(q_dtype)


def split_softmax_plain(segments, q_dtype: torch.dtype, ns: int) -> torch.Tensor:
    """``online_softmax_plain`` as the split kernel computes it: ``ns``
    ranks' partial states, merged in rank order."""
    return merge_partials_plain(rank_partials_plain(segments, ns), q_dtype)


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid entries, the current token included
    window: int = 0,
    *,
    scale: float,
    softmax: Callable = online_softmax_plain,
) -> torch.Tensor:
    """Plain PyTorch in the kernel's arithmetic. Returns (B, H, D).
    ``softmax(segments, q_dtype)``: ``online_softmax_plain``, or the split
    kernel's emulation (``split_softmax_plain`` with its ``ns``)."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qs = (q * torch.tensor(scale, dtype=q.dtype)).reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qs, k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]
    n = lengths.to(q.device).long()[:, None]
    lo = torch.clamp(n - window, min=0) if window > 0 else torch.zeros_like(n)
    ok = ((pos < n) & (pos >= lo))[:, None, None, :]  # (B, 1, 1, S)
    v = v_cache.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, S, D)
    out = softmax([(s, ok, v)], q.dtype)
    return out.reshape(B, H, D)


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D); the head dim contiguous
    v_cache: torch.Tensor,  # (B, S, Hkv, D), at k_cache's strides
    lengths: torch.Tensor,  # (B,) int32 valid entries
    window: int = 0,  # sliding window; 0 = none
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode attention. Returns (B, H, D) in q's dtype."""
    B, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, window, scale=scale)
    _build.require_cuda(q, k_cache, v_cache, lengths)
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if k_cache.shape != (B, S, Hkv, D) or v_cache.shape != k_cache.shape or H % Hkv:
        raise ValueError(f"bad shapes for decode_attention: q {q.shape}, cache {k_cache.shape}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError("q and the cache must share one dtype")
    if q.stride(-1) != 1 or k_cache.stride(-1) != 1 or k_cache.stride() != v_cache.stride():
        raise ValueError("the head dim must be contiguous and k, v must share strides")
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise TypeError(f"lengths must be a contiguous int32 ({B},) tensor")
    check_kv_aligned("decode_attention", k_cache, v_cache)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 5)(q.stride(0), q.stride(1), *k_cache.stride()[:3])
    lib = _build.library("decode_attention")
    rc = lib.uv_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(out), strides,
        _build.ptr(lengths), int(window), B, H, H // Hkv, S, D,
        rounded_scale(scale, q.dtype), kv_splits(S), _build.dtype_code(q),
        _build.stream_ptr(q.device),
    )
    _build.check("decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
