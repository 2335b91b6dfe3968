"""The encoder-attention probes of ``ultravox_torch.scripts.profile_encoder_attn``,
with their plain version.

``attn_v2`` and ``attn_nt`` (``csrc/encoder_attn_probe.cu``, entry points
``uv_attn_v2`` and ``uv_attn_nt``) replace ``scripts/profile_encoder_attn.py``'s
``attn_v2`` (:75) and ``attn_nt`` (:140): masked, non-causal attention of q
(B, T, H, D) against k, v (B, S, H, D) with an optional key length per row,
returning (B, T, H, D), with the exponent taken in fp32 or bf16
(``exp_dtype``). ``attn_v2`` copies q, k and v to head-major, runs the
kernel on the copies and copies the output back, as the reference does;
those copies are part of what it measures. ``attn_nt`` reads and writes
the native layout in place. ``block_q`` is the reference's query block: T
must be a multiple of it (the reference's grid would leave the rest
unwritten), and the card's kernel tiles queries by 64 rows whatever it is.
bf16 tensors must start on 16-byte boundaries (the kernel copies 16-byte
pieces).

Each wrapper takes the plain version for CPU tensors and launches the
kernel for CUDA tensors; ``attn_v2.launches`` and ``attn_nt.launches``
count the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ultravox_torch.ops.attention import NEG_INF
from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels.fused_attention import HEAD_DIMS, LOG2E, check_aligned

EXP_DTYPES = (torch.float32, torch.bfloat16)
LN2_BF16 = 0.69140625  # ln 2 rounded to bf16, as JAX's exp2 of a bf16 value uses it


def attn_probe_plain(q, k, v, lengths=None, *, scale: float, exp_dtype=torch.float32):
    """The probes' arithmetic: fp32 logits times scale*log2(e), + NEG_INF on
    keys at or past lengths[b], exp2 against the row max (with a bf16
    exponent: s - m rounded to bf16 and exp2 of it as JAX takes it for a
    bf16 argument, exp(x * ln 2) with ln 2, the product and the result each
    rounded to bf16; summed in fp32), PV in v's dtype with fp32 sums,
    division by the row sum last."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (scale * LOG2E)
    if lengths is not None:
        cols = torch.arange(k.shape[1], device=q.device)
        visible = cols[None, :] < lengths.to(q.device).long()[:, None]
        s = s + torch.where(visible, 0.0, NEG_INF)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    if exp_dtype == torch.bfloat16:
        e = torch.exp((s - m).to(torch.bfloat16) * LN2_BF16)
        z = e.float().sum(dim=-1, keepdim=True)
    else:
        e = torch.exp2(s - m)
        z = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), vh.float())
    return (o / z).to(q.dtype).transpose(1, 2)


def _check(q, k, v, block_q: int, exp_dtype) -> None:
    B, T, H, D = q.shape
    if block_q <= 0 or T % block_q:
        raise ValueError(f"T={T} is not a multiple of block_q={block_q}")
    if exp_dtype not in EXP_DTYPES:
        raise ValueError(f"exp_dtype must be float32 or bfloat16, got {exp_dtype}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"bad shapes: q {q.shape}, k {k.shape}, v {v.shape}")


def _launch(entry, q, k, v, out, lengths, scale, exp_dtype, B, T, S, H, D):
    _build.require_cuda(q, k, v, out, lengths)
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("q, k and v must share one dtype")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{entry} takes contiguous q, k and v")
    if q.dtype == torch.bfloat16:
        check_aligned(entry, (q, k, v, out))
    lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
    rc = getattr(_build.library("encoder_attn_probe"), f"uv_{entry}")(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), B, T, S, H, D,
        scale * LOG2E, _build.ptr(lens), int(exp_dtype == torch.bfloat16),
        _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("encoder_attn_probe", rc)


def attn_v2(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    lengths: Optional[torch.Tensor] = None,  # (B,) valid keys; None: no mask
    *,
    scale: float,
    block_q: int,
    exp_dtype=torch.float32,
) -> torch.Tensor:
    """The head-major probe: q, k, v transposed to (B, H, *, D) copies, the
    kernel on them, the output transposed back. Returns (B, T, H, D)."""
    _check(q, k, v, block_q, exp_dtype)
    if q.device.type == "cpu":
        return attn_probe_plain(q, k, v, lengths, scale=scale, exp_dtype=exp_dtype)
    B, T, H, D = q.shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = torch.empty_like(qt)
    _launch("attn_v2", qt, kt, vt, out, lengths, scale, exp_dtype, B, T, k.shape[1], H, D)
    attn_v2.launches += 1
    return out.transpose(1, 2).contiguous()


attn_v2.launches = 0


def attn_nt(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    lengths: Optional[torch.Tensor] = None,
    *,
    scale: float,
    block_q: int,
    exp_dtype=torch.float32,
) -> torch.Tensor:
    """The transpose-free probe: the kernel reads q, k, v and writes the
    output in the native (B, T, H, D) layout. Returns (B, T, H, D)."""
    _check(q, k, v, block_q, exp_dtype)
    if q.device.type == "cpu":
        return attn_probe_plain(q, k, v, lengths, scale=scale, exp_dtype=exp_dtype)
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    _launch("attn_nt", q, k, v, out, lengths, scale, exp_dtype, B, T, k.shape[1], H, D)
    attn_nt.launches += 1
    return out


attn_nt.launches = 0
