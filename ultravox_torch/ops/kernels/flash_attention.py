"""Differentiable self-attention for training (``csrc/flash_attention.cu``)
and its plain version.

``flash_attention`` replaces ``ultravox_tpu/ops/pallas/flash_attention.py:
flash_attention``, the training path's attention in both towers: (B, T, H,
D) queries against (B, T, Hkv, D) keys/values of the same sequence (GQA),
with masks from scalars (``lengths``, ``causal``, a runtime ``window``,
``latency_block``). Both versions are ``torch.autograd.Function``s:

- ``_FlashKernel`` for CUDA tensors: ``flash_forward``'s kernel also saves
  each row's fp32 maximum and sum, and ``flash_backward`` launches three
  kernels (delta, dK/dV, dQ). ``flash_attention.launches`` counts forward
  launches and ``flash_attention.bwd_launches`` backward ones
  (``BWD_LAUNCHES`` per backward call).
- ``_FlashPlain`` for CPU tensors: the forward follows ``_fwd_kernel``'s
  arithmetic and the backward ``_bwd_kernel``'s explicit formulas (not
  autograd of the forward), rounding points included, so the CPU path
  reproduces the JAX custom VJP and the card can hold the kernels' backward
  against it in bf16.

The JAX package's ``supports_shape`` is a VMEM fit test for the TPU; the
CUDA kernels loop over key tiles and run at any T, so the port has none.
"""

from __future__ import annotations

from typing import Optional

import torch

from ultravox_torch.ops.attention import NEG_INF
from ultravox_torch.ops.kernels import _build

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)  # head dims the kernels are instantiated for
BWD_LAUNCHES = 3  # kernels one backward call launches: delta, dK/dV, dQ


def _visible(lengths, T: int, causal: bool, window: int, latency_block: int, device):
    """(B|1, 1, T, T) bool: key j visible from query row i, as the Pallas
    kernels' ``_mask_block``; None when every key is visible."""
    cols = torch.arange(T, device=device)[None, None, None, :]
    rows = torch.arange(T, device=device)[None, None, :, None]
    ok = None

    def _and(m, x):
        return x if m is None else m & x

    if lengths is not None:
        ok = _and(ok, cols < lengths.to(device).long()[:, None, None, None])
    if causal:
        ok = _and(ok, cols <= rows)
        if window > 0:
            ok = _and(ok, rows - cols < window)
    if latency_block > 0:
        ok = _and(ok, cols // latency_block <= rows // latency_block)
    return ok


def _probs(q, k, lengths, scale, causal, window, latency_block):
    """Head-major fp32 (e, z, visible): e = exp2(s - rowmax) of the logits
    s = q.k * scale * log2(e) (NEG_INF where hidden) and z its row sum."""
    group = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).float()  # (B, H, T, D)
    kh = k.transpose(1, 2).float().repeat_interleave(group, dim=1)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (scale * LOG2E)
    ok = _visible(lengths, q.shape[1], causal, window, latency_block, q.device)
    if ok is not None:
        s = torch.where(ok, s, NEG_INF)
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True), ok


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, H, T, D) per query head -> (B, T, Hkv, D) summed over each group."""
    B, H, T, D = x.shape
    return x.reshape(B, hkv, H // hkv, T, D).sum(dim=2).transpose(1, 2)


def flash_forward_plain(q, k, v, lengths=None, *, scale, causal=False, window=0, latency_block=0):
    """``_fwd_kernel`` in plain PyTorch: probabilities rounded to v's dtype
    before the fp32-accumulated PV product, the row sum divides last.
    Returns (B, T, H, D) in q's dtype."""
    e, z, _ = _probs(q, k, lengths, scale, causal, window, latency_block)
    group = q.shape[2] // k.shape[2]
    vh = v.transpose(1, 2).float().repeat_interleave(group, dim=1)
    o = torch.matmul(e.to(v.dtype).float(), vh) / z
    return o.to(q.dtype).transpose(1, 2)


def flash_backward_plain(q, k, v, o, dout, lengths=None, *, scale, causal=False, window=0,
                         latency_block=0):
    """``_bwd_kernel``'s formulas: dv += p.astype(do)^T do; dp = do v^T;
    ds = p (dp - rowsum(do o)), 0 where hidden; ds16 = (ds scale).astype(q);
    dq = ds16 k; dk += ds16^T q; all fp32-accumulated, cast at the end.
    Returns (dq, dk, dv) in the dtypes and layouts of q, k, v."""
    Hkv = k.shape[2]
    group = q.shape[2] // Hkv
    e, z, ok = _probs(q, k, lengths, scale, causal, window, latency_block)
    p = e / z
    do = dout.to(q.dtype)
    do_h = do.transpose(1, 2)  # (B, H, T, D) in q's dtype
    dof = do_h.float()
    vh = v.transpose(1, 2).float().repeat_interleave(group, dim=1)
    kh = k.transpose(1, 2).float().repeat_interleave(group, dim=1)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vh.transpose(-1, -2))
    delta = (dof * o.transpose(1, 2).float()).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if ok is not None:
        ds = torch.where(ok, ds, 0.0)
    ds16 = (ds * scale).to(q.dtype).float()
    dq = torch.matmul(ds16, kh).transpose(1, 2)
    dk = torch.matmul(ds16.transpose(-1, -2), q.transpose(1, 2).float())
    return (dq.to(q.dtype), _group_sum(dk, Hkv).to(k.dtype), _group_sum(dv, Hkv).to(v.dtype))


class _FlashPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal, window, latency_block):
        o = flash_forward_plain(q, k, v, lengths, scale=scale, causal=causal, window=window,
                                latency_block=latency_block)
        ctx.save_for_backward(q, k, v, o, lengths)
        ctx.opts = dict(scale=scale, causal=causal, window=window, latency_block=latency_block)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lengths = ctx.saved_tensors
        dq, dk, dv = flash_backward_plain(q, k, v, o, dout, lengths, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, lengths):
    B, T, H, D = q.shape
    _build.require_cuda(q, k, v, lengths)
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    Hkv = k.shape[2]
    if k.shape != (B, T, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"bad shapes for flash_attention: q {q.shape}, k {k.shape}, v {v.shape}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    _build.dtype_code(q)
    if lengths is not None and lengths.shape != (B,):
        raise ValueError(f"lengths must be ({B},), got {tuple(lengths.shape)}")


def flash_forward(q, k, v, lengths=None, *, scale, causal=False, window=0, latency_block=0):
    """The forward kernel: (out (B, T, H, D), stats (B, H, T, 2) fp32 row
    maxima and sums) for CUDA tensors."""
    _check(q, k, v, lengths)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
    B, T, H, D = q.shape
    o = torch.empty_like(q)
    stats = torch.empty((B, H, T, 2), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    rc = lib.uv_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(stats),
        _build.ptr(lens), B, H, H // k.shape[2], T, D, scale * LOG2E, int(causal), int(window),
        int(latency_block), _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("flash_attention", rc)
    flash_attention.launches += 1
    return o, stats


def flash_backward(q, k, v, o, stats, dout, lengths=None, *, scale, causal=False, window=0,
                   latency_block=0):
    """The backward kernels (delta, dK/dV, dQ) from ``flash_forward``'s
    output and stats: (dq, dk, dv) for CUDA tensors."""
    _check(q, k, v, lengths)
    q, k, v, o = q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous()
    lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
    B, T, H, D = q.shape
    do = dout.to(q.dtype).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    rc = lib.uv_flash_attention_bwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(do),
        _build.ptr(stats), _build.ptr(delta), _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
        _build.ptr(lens), B, H, H // k.shape[2], T, D, scale * LOG2E, scale, int(causal),
        int(window), int(latency_block), _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("flash_attention", rc)
    flash_attention.bwd_launches += BWD_LAUNCHES
    return dq, dk, dv


class _FlashKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, scale, causal, window, latency_block):
        opts = dict(scale=scale, causal=causal, window=window, latency_block=latency_block)
        o, stats = flash_forward(q, k, v, lengths, **opts)
        ctx.save_for_backward(q, k, v, o, stats, lengths)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, stats, lengths = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, stats, dout, lengths, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, T, Hkv, D): self-attention, S == T
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,  # (B,) valid key length
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    window: int = 0,  # sliding window (0 = off; needs causal)
    latency_block: int = 0,
) -> torch.Tensor:
    """Differentiable fused self-attention. Returns (B, T, H, D) in q's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernels or raise (head dims other than 64/128, dtypes other than
    fp32/bf16)."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention is self-attention only (T={q.shape[1]} vs S={k.shape[1]}); "
            "use the inference kernels for cached decode."
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    fn = _FlashPlain if q.device.type == "cpu" else _FlashKernel
    return fn.apply(q, k, v, lengths, float(scale), bool(causal), int(window), int(latency_block))


flash_attention.launches = 0
flash_attention.bwd_launches = 0
