"""Decode attention kernel (``csrc/decode_attention.cu``) and its plain version.

``decode_attention`` replaces ``ultravox_tpu/ops/pallas/decode_attention.py:
decode_attention``: one query per row against a (B, S, Hkv, D) cache slab,
keys in [max(n - window, 0), n) (all of [0, n) when window <= 0), GQA. The
wrapper takes its plain version for CPU tensors and launches the kernel for
CUDA tensors; ``decode_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ultravox_torch.ops.attention import NEG_INF
from ultravox_torch.ops.kernels import _build

HEAD_DIMS = (64, 128)  # head dims the kernel is instantiated for


@functools.lru_cache(maxsize=None)
def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` as the TPU kernels apply it: rounded to the query's dtype."""
    return float(torch.tensor(scale, dtype=dtype))


def online_softmax_plain(segments, q_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' softmax over key segments without concatenating them.
    Each segment is (logits (..., S) fp32, visible (..., S) bool, values
    (..., S, D) fp32). Hidden logits take NEG_INF and probability 0; the
    probabilities stay fp32 into the PV product; the output is
    acc / max(z, 1e-30) in ``q_dtype``."""
    m = None
    for s, ok, _ in segments:
        sm = s.masked_fill(~ok, NEG_INF).amax(dim=-1, keepdim=True)
        m = sm if m is None else torch.maximum(m, sm)
    z, acc = 0.0, 0.0
    for s, ok, v in segments:
        e = torch.where(ok, torch.exp(s - m), torch.zeros((), device=s.device))
        z = z + e.sum(dim=-1, keepdim=True)
        acc = acc + torch.matmul(e[..., None, :], v)[..., 0, :]
    return (acc / torch.clamp(z, min=1e-30)).to(q_dtype)


def decode_attention_plain(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    lengths: torch.Tensor,  # (B,) valid entries, the current token included
    window: int = 0,
    *,
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch in the kernel's arithmetic. Returns (B, H, D)."""
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
    out = online_softmax_plain([(s, ok, v)], q.dtype)
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
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 5)(q.stride(0), q.stride(1), *k_cache.stride()[:3])
    lib = _build.library("decode_attention")
    rc = lib.uv_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(out), strides,
        _build.ptr(lengths), int(window), B, H, H // Hkv, S, D,
        rounded_scale(scale, q.dtype), _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
