"""Attention primitives: GQA multi-head attention with fp32 softmax and
additive-bias masks. Masks stay finite (``NEG_INF``), never ``-inf``, so a
fully masked row softmaxes to a finite uniform average instead of NaN."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    *,
    bias: Optional[torch.Tensor] = None,  # broadcastable to (B, H, T, S)
    scale: Optional[float] = None,
    softcap: Optional[float] = None,  # gemma-2 attention logit softcapping
) -> torch.Tensor:
    """Returns (B, T, H, D) in q's dtype. Logits and softmax in fp32; the
    probabilities are cast to v's dtype before the PV product (as the
    reference does with an fp32-accumulated bf16 dot). ``softcap`` applies
    ``tanh(logits / cap) * cap`` before the bias, in the reference's order."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    group = H // Hkv
    if scale is None:
        scale = D**-0.5
    qf = (q * scale).reshape(B, T, Hkv, group, D).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qf, k.float())
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if bias is not None:
        b = bias.float().expand(B, H, T, S) if bias.ndim == 4 else bias.float()
        logits = logits + b.reshape(B, Hkv, group, T, S)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D), one query step
    k_cache: torch.Tensor,  # (B, S_max, Hkv, D)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) valid prefix incl. this step
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-step decode attention against a static-shape cache: positions
    >= ``cache_len`` are masked out. Returns (B, 1, H, D)."""
    S = k_cache.shape[1]
    valid = torch.arange(S, device=q.device)[None, :] < cache_len.to(q.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(valid, zero, NEG_INF)[:, None, None, :]
    return mha(q, k_cache, v_cache, bias=bias, scale=scale)


def length_mask_bias(
    lengths: torch.Tensor, seq_len: int, *, dtype=torch.float32
) -> torch.Tensor:
    """Additive bias (B, 1, 1, S): 0 for positions < length, NEG_INF after."""
    pos = torch.arange(seq_len, device=lengths.device)[None, :]
    valid = pos < lengths[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(valid, zero, NEG_INF)[:, None, None, :].to(dtype)


def block_causal_bias(seq_len: int, block_size: int, device=None) -> torch.Tensor:
    """Block-causal latency mask (1, 1, T, T): i sees j iff
    ``j // block_size <= i // block_size``."""
    blk = torch.arange(seq_len, device=device) // block_size
    allowed = blk[None, :] <= blk[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, NEG_INF)[None, None]
