"""Attention kernels of the encoder and of causal prefill, with plain versions.

- ``ln_qkv_head_fused`` (``csrc/ln_qkv_head.cu``) replaces
  ``ultravox_tpu/ops/pallas/fused_attention.py:ln_qkv_head_fused``. bf16
  runs on the tensor cores (``csrc/mma_rows.cuh``) where ``_plan`` allows
  it; fp32 and every other shape or alignment on the CUDA cores.
- ``attention_headmajor`` and ``fused_attention`` (both ``csrc/attention.cu``)
  replace ``fused_attention.py:attention_headmajor`` (``_headmajor_kernel``)
  and ``fused_attention.py:fused_attention`` (``_attn_kernel``).
- ``qkv_head_transpose`` (``csrc/qkv_head_transpose.cu``) replaces
  ``fused_attention.py:qkv_head_transpose``.
- ``ln_matmul_gelu`` (``csrc/ln_matmul_gelu.cu``) and
  ``attn_out_proj_residual`` (``csrc/attn_out_proj.cu``) replace
  ``fused_attention.py:ln_matmul_gelu`` and ``:attn_out_proj_residual``.
  The reference wires neither into its encoder, and neither does the port.
  In bf16 both run on the tensor cores (``csrc/mma_rows.cuh``) where
  ``_gelu_plan`` and ``_out_proj_plan`` allow it; fp32 and every other
  shape or alignment on the CUDA cores.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors; ``<wrapper>.launches`` counts kernel launches.
What bounds each kernel on the card, and what its design does about it, is
noted at the top of its CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ultravox_torch.ops.attention import NEG_INF
from ultravox_torch.ops.kernels import _build

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)  # head dims the attention kernel is instantiated for
VEC_BYTES = 16  # qkv_head_transpose and bf16 attention move 16 bytes per load and store
# widest contraction whose 32 rows fit in shared memory beside the weight
# tile (csrc/row_tile.cuh: (32 * K + 32 * 128) * 4 bytes <= 232448)
ROW_TILE_MAX_K = (232448 - 32 * 128 * 4) // (32 * 4)
MAX_SMEM = 232448  # shared memory a block may use on sm_90
# rows of ln_qkv_head's tensor-core tiles (csrc/ln_qkv_head.cu
# uv_ln_qkv_head_mma), largest first; each is MMA_BN columns wide
MMA_ROWS = (128, 64, 32)
MMA_BN = 128
MMA_MAX_D = 2048  # widest row of csrc/mma_rows.cuh
RING_ROWS, RING_STAGES = 32, 3  # the weight ring of csrc/mma_rows.cuh
# qkv_head_transpose's rows of T a block may own, most first, and the
# blocks per SM its plan asks for
TRANSPOSE_ROWS = (16, 8, 4, 2, 1)
TRANSPOSE_BLOCKS_PER_SM = 2
SM_SMEM = 233472  # shared memory of one SM on sm_90 (each block also takes 1 KB)
# ln_matmul_gelu: what one LayerNorm of a block's rows costs, in column
# tiles of the product (ln_qkv_head's phase stamps, PERF.md: about one)
GELU_LN_TILES = 1
# attn_out_proj_residual's cost model, in products of a 128-row column
# tile, fitted to the card's sweep of every tile (PERF.md): what a
# block's gather of its rows costs (a copy, well under a tile), what a
# column tile costs beside its product (its weight stream, the ring's fill
# and the epilogue: the same for a tile of any rows), and the rows below
# which a block's product runs no faster (its 2 warps leave half of an
# SM's 4 sub-partitions idle)
OUT_PROJ_GATHER_TILES = 0.2
OUT_PROJ_TILE_COST = 0.75
OUT_PROJ_MIN_ROWS = 64


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _layer_norm_rounded(x, ln_scale, ln_bias, eps):
    """LayerNorm in fp32, cast to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()).to(x.dtype)


def ln_qkv_head_plain(x, ln_scale, ln_bias, kernel, bias, head_dim: int, eps: float = 1e-5):
    """(B, T, D) -> (B, C / head_dim, T, head_dim): LN in fp32, cast to x's
    dtype, fp32-accumulated product, cast, then + bias in that dtype."""
    B, T, D = x.shape
    C = kernel.shape[-1]
    h = _layer_norm_rounded(x, ln_scale, ln_bias, eps)
    acc = torch.matmul(h.float(), kernel.float())
    qkv = acc.to(x.dtype) + bias.to(x.dtype)
    return qkv.reshape(B, T, C // head_dim, head_dim).permute(0, 2, 1, 3).contiguous()


def ln_matmul_gelu_plain(x, ln_scale, ln_bias, kernel, bias, eps: float = 1e-5):
    """(B, T, D) -> (B, T, F): LN in fp32, cast to x's dtype, fp32-accumulated
    product, cast, + bias in that dtype, then tanh-GELU in fp32 and cast."""
    h = _layer_norm_rounded(x, ln_scale, ln_bias, eps)
    acc = torch.matmul(h.float(), kernel.float())
    y = (acc.to(x.dtype) + bias.to(x.dtype)).float()
    g = 0.5 * y * (1.0 + torch.tanh(0.7978845608028654 * (y + 0.044715 * y * y * y)))
    return g.to(x.dtype)


def attn_out_proj_residual_plain(attn_t, kernel_w, bias, x_res):
    """x_res + (heads-concat of attn_t (B, H, T, D)) @ W (H, D, M) + b: fp32
    sums cast to x_res's dtype, + b, then the residual, in that dtype."""
    B, H, T, D = attn_t.shape
    M = kernel_w.shape[-1]
    a = attn_t.transpose(1, 2).reshape(B, T, H * D)
    acc = torch.matmul(a.float(), kernel_w.reshape(H * D, M).float())
    return x_res + (acc.to(x_res.dtype) + bias)


def qkv_head_transpose_plain(qkv: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, T, G * head_dim) -> (B, G, T, head_dim), contiguous."""
    B, T, C = qkv.shape
    return qkv.view(B, T, C // head_dim, head_dim).permute(0, 2, 1, 3).contiguous()


def attention_plain(
    q: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    lengths: Optional[torch.Tensor] = None,
    row_offsets: Optional[torch.Tensor] = None,
    *,
    scale: float,
    causal: bool = False,
    latency_block: int = 0,
) -> torch.Tensor:
    """Head-major attention in the TPU kernels' arithmetic: fp32 logits times
    scale*log2(e), masked entries set to NEG_INF, exp2 against the row max,
    probabilities rounded to v's dtype before PV, division by the row sum
    last. Returns (B, H, T, D) in q's dtype."""
    B, H, T, D = q.shape
    S = k.shape[2]
    group = H // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * (scale * LOG2E)
    dev = q.device
    cols = torch.arange(S, device=dev)[None, None, None, :]
    rows = torch.arange(T, device=dev)[None, :]
    if row_offsets is not None:
        rows = rows + row_offsets.to(dev).long()[:, None]
    rows = rows[:, None, :, None]  # (B|1, 1, T, 1)
    hidden = torch.zeros((1, 1, 1, S), dtype=torch.bool, device=dev)
    if lengths is not None:
        hidden = hidden | (cols >= lengths.to(dev).long()[:, None, None, None])
    if causal:
        hidden = hidden | (cols > rows)
    if latency_block > 0:
        hidden = hidden | (cols // latency_block > rows // latency_block)
    s = s.masked_fill(hidden, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    z = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), vf.float())
    return (o / z).to(q.dtype)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------


def mma_smem_bytes(bm: int, D: int, ln: bool = True) -> int:
    """Dynamic shared memory of a tensor-core block (csrc/mma_rows.cuh
    smem_bytes): the LN scale and bias (fp32; none where ``ln`` is false),
    then BM resident rows of pitch D + 8 and the 3-stage ring of 32 x
    (MMA_BN + 8) weight tiles, or the BM x (MMA_BN + 8) epilogue tile if
    larger."""
    main = bm * (D + 8) + RING_STAGES * RING_ROWS * (MMA_BN + 8)
    return (8 * D if ln else 0) + 2 * max(main, bm * (MMA_BN + 8))


class Plan(NamedTuple):
    mma: bool  # the tensor-core kernel, else the CUDA-core row tile
    bm: int  # output rows a block owns
    bn: int  # output columns a block owns
    smem: int  # its dynamic shared memory, bytes


def _plan(bf16: bool, rows: int, D: int, C: int, Dh: int, ptrs, bm: Optional[int] = None) -> Plan:
    """ln_qkv_head_fused's kernel and tile for ``rows`` rows of (rows, D) x
    (D, C) in heads of Dh, whose x, LN vectors, weight and output start at
    ``ptrs``. The tensor-core kernel takes bf16 with D % 16 == 0 (up to
    MMA_MAX_D), C % 8 == 0, Dh % 8 == 0 (a 16-byte line lies in one head)
    and 16-byte-aligned pointers, in MMA_BN-wide tiles of the fewest rows
    of MMA_ROWS that hold all ``rows``, else of the most that fit in shared
    memory (on the H100 fewer rows, 64-column tiles and blocks that run
    several column tiles from one LayerNorm all measured slower at the
    encoder's shapes; PERF.md). Everything else (fp32, other shapes,
    unaligned views) takes the CUDA-core 32 x 128 row tile. ``bm`` forces
    the tensor-core tile's rows (ValueError where it cannot run)."""
    mma = (bf16 and D % 16 == 0 and D <= MMA_MAX_D and C % 8 == 0 and Dh % 8 == 0
           and all(p % 16 == 0 for p in ptrs))
    fits = [m for m in MMA_ROWS if mma_smem_bytes(m, D) <= MAX_SMEM] if mma else []
    if bm is not None:
        if bm not in fits:
            raise ValueError(f"ln_qkv_head_fused: a {bm}-row tile cannot run at D={D}, C={C}, "
                             f"Dh={Dh} (rows that can: {fits})")
    elif not fits:
        return Plan(False, 32, 128, (32 * D + 32 * 128) * 4)
    else:
        bm = min((m for m in fits if m >= rows), default=fits[0])
    return Plan(True, bm, MMA_BN, mma_smem_bytes(bm, D))


def ln_qkv_head_fused(x, ln_scale, ln_bias, kernel, bias, head_dim: int, *, eps: float = 1e-5):
    """LayerNorm -> (T, D) x (D, C) + bias -> head-major (B, C/Dh, T, Dh)."""
    if x.device.type == "cpu":
        return ln_qkv_head_plain(x, ln_scale, ln_bias, kernel, bias, head_dim, eps)
    _build.require_cuda(x, ln_scale, ln_bias, kernel, bias)
    B, T, D = x.shape
    C = kernel.shape[-1]
    if kernel.shape != (D, C) or bias.shape != (C,) or C % head_dim:
        raise ValueError(f"bad shapes for ln_qkv_head_fused: {x.shape} x {kernel.shape} + {bias.shape}")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel dtype {kernel.dtype} != activation dtype {x.dtype}")
    x = x.contiguous()
    w = kernel.contiguous()
    b = bias.to(x.dtype).contiguous()
    s32 = ln_scale.float().contiguous()
    b32 = ln_bias.float().contiguous()
    out = torch.empty((B, C // head_dim, T, head_dim), dtype=x.dtype, device=x.device)
    plan = _plan(x.dtype == torch.bfloat16, B * T, D, C, head_dim,
                 [t.data_ptr() for t in (x, s32, b32, w, out)])
    lib = _build.library("ln_qkv_head")
    args = (_build.ptr(x), _build.ptr(s32), _build.ptr(b32), _build.ptr(w), _build.ptr(b),
            _build.ptr(out), B, T, D, C, head_dim, eps)
    if plan.mma:
        rc = lib.uv_ln_qkv_head_mma(*args, plan.bm, _build.stream_ptr(x.device))
    else:
        rc = lib.uv_ln_qkv_head(*args, _build.dtype_code(x), _build.stream_ptr(x.device))
    _build.check("ln_qkv_head", rc)
    ln_qkv_head_fused.launches += 1
    return out


ln_qkv_head_fused.launches = 0


class TransposePlan(NamedTuple):
    rows: int  # rows of T a block owns
    heads: int  # heads a block owns
    blocks: int  # blocks of the grid
    smem: int  # a block's dynamic shared memory, bytes


def _transpose_plan(B: int, T: int, G: int, head_bytes: int, sms: int,
                    rows: Optional[int] = None) -> TransposePlan:
    """qkv_head_transpose's tile (csrc/qkv_head_transpose.cu): a block owns
    ``rows`` rows of T of one batch row and ``heads`` heads, staged in
    shared memory whole. The rows are the most of TRANSPOSE_ROWS that still
    give every SM TRANSPOSE_BLOCKS_PER_SM blocks, else the fewest; heads
    are all G where the tile fits a block's shared memory, else as many as
    fit. ``rows`` forces the rows (any positive count)."""
    if rows is None:
        rows = next((r for r in TRANSPOSE_ROWS
                     if B * -(-T // r) >= TRANSPOSE_BLOCKS_PER_SM * sms), TRANSPOSE_ROWS[-1])
    heads = min(G, (MAX_SMEM - 16) // (rows * head_bytes))
    if rows <= 0 or heads <= 0:
        raise ValueError(f"qkv_head_transpose: {rows} rows of {head_bytes}-byte heads do not fit")
    return TransposePlan(rows, heads, B * -(-T // rows) * -(-G // heads), rows * heads * head_bytes)


def qkv_head_transpose(qkv: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Head-major relayout of a fused q/k/v projection's output: (B, T,
    G * head_dim) -> (B, G, T, head_dim), any T, fp32 or bf16, in the
    input's dtype. The input must be contiguous."""
    if qkv.device.type == "cpu":
        return qkv_head_transpose_plain(qkv, head_dim)
    _build.require_cuda(qkv)
    B, T, C = qkv.shape
    if head_dim not in HEAD_DIMS or C % head_dim:
        raise ValueError(f"qkv_head_transpose: width {C} is no multiple of a head dim in {HEAD_DIMS}")
    if not qkv.is_contiguous():
        raise ValueError("qkv_head_transpose takes a contiguous (B, T, G * head_dim) tensor")
    _build.dtype_code(qkv)  # raises for types other than fp32 and bf16
    if qkv.data_ptr() % VEC_BYTES:  # a head (64 or 128 of 2 or 4 bytes) is whole units
        raise ValueError(f"qkv_head_transpose copies in {VEC_BYTES}-byte units: the base must "
                         f"be {VEC_BYTES}-byte aligned")
    G, head_bytes = C // head_dim, head_dim * qkv.element_size()
    plan = _transpose_plan(B, T, G, head_bytes, _build.sm_count(qkv.device.index or 0))
    out = torch.empty((B, G, T, head_dim), dtype=qkv.dtype, device=qkv.device)
    lib = _build.library("qkv_head_transpose")
    rc = lib.uv_qkv_head_transpose(
        _build.ptr(qkv), _build.ptr(out), B, T, G, head_bytes, plan.rows, plan.heads,
        _build.stream_ptr(qkv.device),
    )
    _build.check("qkv_head_transpose", rc)
    qkv_head_transpose.launches += 1
    return out


qkv_head_transpose.launches = 0


class TilesPlan(NamedTuple):
    """ln_matmul_gelu's and attn_out_proj_residual's kernel and tile."""
    mma: bool  # the tensor-core kernel, else the CUDA-core row tile
    bm: int  # output rows a block owns
    bn: int  # columns of one column tile
    tiles: int  # column tiles a block runs in turn from its resident rows
    smem: int  # its dynamic shared memory, bytes


def _gelu_plan(bf16: bool, rows: int, D: int, F: int, ptrs, sms: int, bm: Optional[int] = None,
               tiles: Optional[int] = None) -> TilesPlan:
    """ln_matmul_gelu's kernel and tile for (rows, D) x (D, F) whose x, LN
    vectors, weight and output start at ``ptrs``. The tensor-core kernel
    takes bf16 with D % 16 == 0 (up to MMA_MAX_D), F % 8 == 0 and 16-byte-
    aligned pointers, with _plan's rows (the fewest of MMA_ROWS that hold
    all ``rows``, else the most that fit). A block runs ``tiles`` MMA_BN-wide
    column tiles from one LayerNorm: the count that minimises waves x (tiles
    + GELU_LN_TILES) on ``sms`` SMs, a LayerNorm costing GELU_LN_TILES
    column tiles; the fewest tiles on a tie. Everything else (fp32, other
    shapes, unaligned views) takes the CUDA-core 32 x 128 row tile. ``bm``
    and ``tiles`` force the tile (ValueError where it cannot run)."""
    mma = (bf16 and D % 16 == 0 and D <= MMA_MAX_D and F % 8 == 0
           and all(p % 16 == 0 for p in ptrs))
    fits = [m for m in MMA_ROWS if mma_smem_bytes(m, D) <= MAX_SMEM] if mma else []
    if bm is not None or tiles is not None:
        if (bm is not None and bm not in fits) or not fits or (tiles is not None and tiles < 1):
            raise ValueError(f"ln_matmul_gelu: a {bm}-row tile of {tiles} column tiles cannot "
                             f"run at D={D}, F={F} (rows that can: {fits})")
    if not fits:
        return TilesPlan(False, 32, 128, 1, (32 * D + 32 * 128) * 4)
    if bm is None:
        bm = min((m for m in fits if m >= rows), default=fits[0])
    smem = mma_smem_bytes(bm, D)
    col_tiles, row_tiles = -(-F // MMA_BN), -(-rows // bm)
    if tiles is None:
        slots = sms * max(1, SM_SMEM // (smem + 1024))  # blocks the card holds at once
        tiles = min(range(1, col_tiles + 1), key=lambda k: (
            -(-row_tiles * -(-col_tiles // k) // slots) * (k + GELU_LN_TILES), k))
    return TilesPlan(True, bm, MMA_BN, min(tiles, col_tiles), smem)


def ln_matmul_gelu(x, ln_scale, ln_bias, kernel, bias, *, eps: float = 1e-5):
    """LayerNorm -> (B, T, D) x (D, F) + bias -> tanh-GELU, (B, T, F), any T;
    x and kernel share fp32 or bf16, bias is cast to x's dtype."""
    if x.device.type == "cpu":
        return ln_matmul_gelu_plain(x, ln_scale, ln_bias, kernel, bias, eps)
    _build.require_cuda(x, ln_scale, ln_bias, kernel, bias)
    B, T, D = x.shape
    F = kernel.shape[-1]
    if kernel.shape != (D, F) or bias.shape != (F,):
        raise ValueError(f"bad shapes for ln_matmul_gelu: {x.shape} x {kernel.shape} + {bias.shape}")
    if D > ROW_TILE_MAX_K:
        raise ValueError(f"ln_matmul_gelu holds rows of at most {ROW_TILE_MAX_K}, got D={D}")
    if kernel.dtype != x.dtype:
        raise TypeError(f"kernel dtype {kernel.dtype} != activation dtype {x.dtype}")
    x = x.contiguous()
    w = kernel.contiguous()
    b = bias.to(x.dtype).contiguous()
    s32 = ln_scale.float().contiguous()
    b32 = ln_bias.float().contiguous()
    out = torch.empty((B, T, F), dtype=x.dtype, device=x.device)
    plan = _gelu_plan(x.dtype == torch.bfloat16, B * T, D, F,
                      [t.data_ptr() for t in (x, s32, b32, w, out)],
                      _build.sm_count(x.device.index or 0))
    lib = _build.library("ln_matmul_gelu")
    args = (_build.ptr(x), _build.ptr(s32), _build.ptr(b32), _build.ptr(w), _build.ptr(b),
            _build.ptr(out), B * T, D, F, eps)
    if plan.mma:
        rc = lib.uv_ln_matmul_gelu_mma(*args, plan.bm, plan.tiles, _build.stream_ptr(x.device))
    else:
        rc = lib.uv_ln_matmul_gelu(*args, _build.dtype_code(x), _build.stream_ptr(x.device))
    _build.check("ln_matmul_gelu", rc)
    ln_matmul_gelu.launches += 1
    return out


ln_matmul_gelu.launches = 0


def _out_proj_plan(bf16: bool, rows: int, H: int, Dh: int, M: int, ptrs, sms: int,
                   bm: Optional[int] = None, tiles: Optional[int] = None) -> TilesPlan:
    """attn_out_proj_residual's kernel and tile for ``rows`` rows of (rows,
    H * Dh) x (H * Dh, M) whose attn, weight, residual and output start at
    ``ptrs``. The tensor-core kernel takes bf16 with K = H * Dh, K % 16 == 0
    (up to MMA_MAX_D), Dh % 8 == 0 (a 16-byte piece lies in one head),
    M % 8 == 0 and 16-byte-aligned pointers, with the tile _out_proj_tile
    picks. Everything else (fp32, other shapes, unaligned views) takes the
    CUDA-core 32 x 128 row tile. ``bm`` and ``tiles`` force the tile
    (ValueError where it cannot run)."""
    K = H * Dh
    mma = (bf16 and K % 16 == 0 and K <= MMA_MAX_D and Dh % 8 == 0 and M % 8 == 0
           and all(p % 16 == 0 for p in ptrs))
    if not mma:
        if bm is not None or tiles is not None:
            raise ValueError(f"attn_out_proj_residual: a {bm}-row tile of {tiles} column tiles "
                             f"cannot run at H={H}, Dh={Dh}, M={M} (no tensor-core route in "
                             f"this dtype, shape and alignment)")
        return TilesPlan(False, 32, 128, 1, (32 * K + 32 * 128) * 4)
    return _out_proj_tile(rows, K, M, sms, bm, tiles)


@functools.lru_cache(maxsize=1024)
def _out_proj_tile(rows: int, K: int, M: int, sms: int, bm: Optional[int] = None,
                   tiles: Optional[int] = None) -> TilesPlan:
    """The tensor-core tile of attn_out_proj_residual: its rows (of
    MMA_ROWS that fit in shared memory) and the MMA_BN-wide column tiles a
    block runs from one gather, the pair of least cost on ``sms`` SMs:
    waves (blocks over SMs) x (tiles x (u + OUT_PROJ_TILE_COST) +
    OUT_PROJ_GATHER_TILES x u), u = max(bm, OUT_PROJ_MIN_ROWS) / MMA_BN; on
    a tie the fewest tiles, then the most rows. Cached: the wrapper asks
    once per shape."""
    fits = [m for m in MMA_ROWS if mma_smem_bytes(m, K, ln=False) <= MAX_SMEM]
    if (bm is not None and bm not in fits) or (tiles is not None and tiles < 1):
        raise ValueError(f"attn_out_proj_residual: a {bm}-row tile of {tiles} column tiles "
                         f"cannot run at K={K}, M={M} (rows that can: {fits})")
    col_tiles = -(-M // MMA_BN)

    def cost(m, k):
        waves = -(-(-(-rows // m) * -(-col_tiles // k)) // sms)
        u = max(m, OUT_PROJ_MIN_ROWS) / MMA_BN
        return waves * (k * (u + OUT_PROJ_TILE_COST) + OUT_PROJ_GATHER_TILES * u)

    bm, tiles = min(((m, k) for m in ([bm] if bm is not None else fits)
                     for k in ([tiles] if tiles is not None else range(1, col_tiles + 1))),
                    key=lambda mk: (cost(*mk), mk[1], -mk[0]))
    return TilesPlan(True, bm, MMA_BN, min(tiles, col_tiles), mma_smem_bytes(bm, K, ln=False))


def attn_out_proj_residual(attn_t, kernel_w, bias, x_res):
    """x_res + (heads-concat of attn_t) @ W + b, reading attn_t (B, H, T, D)
    in its own layout; W is (H, D, M), x_res (B, T, M), any T. attn_t, W and
    x_res share fp32 or bf16; a bias of another dtype than x_res raises
    ValueError, as the reference does."""
    if bias.dtype != x_res.dtype:
        raise ValueError(f"bias dtype {bias.dtype} differs from the residual's {x_res.dtype}")
    if attn_t.device.type == "cpu":
        return attn_out_proj_residual_plain(attn_t, kernel_w, bias, x_res)
    _build.require_cuda(attn_t, kernel_w, bias, x_res)
    B, H, T, D = attn_t.shape
    M = kernel_w.shape[-1]
    if kernel_w.shape != (H, D, M) or bias.shape != (M,) or x_res.shape != (B, T, M):
        raise ValueError(f"bad shapes for attn_out_proj_residual: {attn_t.shape} x "
                         f"{kernel_w.shape} + {bias.shape}, residual {x_res.shape}")
    if not attn_t.dtype == kernel_w.dtype == x_res.dtype:
        raise TypeError("attn_t, kernel_w and x_res must share one dtype")
    a, w, b, r = (t.contiguous() for t in (attn_t, kernel_w, bias, x_res))
    out = torch.empty((B, T, M), dtype=x_res.dtype, device=x_res.device)
    plan = _out_proj_plan(r.dtype == torch.bfloat16, B * T, H, D, M,
                          [t.data_ptr() for t in (a, w, r, out)],
                          _build.sm_count(r.device.index or 0))
    if not plan.mma and H * D > ROW_TILE_MAX_K:
        raise ValueError(f"attn_out_proj_residual holds rows of at most {ROW_TILE_MAX_K} "
                         f"outside the bf16 tensor-core route, got {H} x {D}")
    lib = _build.library("attn_out_proj")
    args = (_build.ptr(a), _build.ptr(w), _build.ptr(b), _build.ptr(r), _build.ptr(out),
            B, H, T, D, M)
    if plan.mma:
        rc = lib.uv_attn_out_proj_mma(*args, plan.bm, plan.tiles, _build.stream_ptr(r.device))
    else:
        rc = lib.uv_attn_out_proj(*args, _build.dtype_code(r), _build.stream_ptr(r.device))
    _build.check("attn_out_proj", rc)
    attn_out_proj_residual.launches += 1
    return out


attn_out_proj_residual.launches = 0


def check_aligned(name: str, tensors, strides=()) -> None:
    """The bf16 attention kernel copies 16-byte pieces (cp.async) and
    stores 16-byte lines: every base pointer and every stride in bytes must
    be a multiple of 16. Raises ValueError otherwise."""
    for t in tensors:
        if t.data_ptr() % VEC_BYTES:
            raise ValueError(f"{name}: bf16 tensors must start on a {VEC_BYTES}-byte boundary "
                             f"(a view at element offset {t.storage_offset()} does not)")
    for s in strides:
        if s * 2 % VEC_BYTES:
            raise ValueError(f"{name}: bf16 strides must be multiples of {VEC_BYTES} bytes, "
                             f"got {s} elements")


def _launch_attention(q, k, v, o, lengths, row_offsets, scale, causal, latency_block):
    """q, o: (B, H, T, D) views; k, v: (B, Hkv, S, D) views; the last axis
    must be contiguous, the others may have any strides (bf16: multiples of
    16 bytes, from 16-byte-aligned bases). lengths and row_offsets: (B,),
    row_offsets >= 0."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv:
        raise ValueError(f"query heads {H} not a multiple of kv heads {Hkv}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype):
        raise TypeError("q, k, v and the output must share one dtype")
    for t in (q, k, v, o):
        if t.stride(-1) != 1:
            raise ValueError("the head dimension must be contiguous")
    _build.require_cuda(q, k, v, o, lengths, row_offsets)
    # the stride of an axis of size 1 is never used and may be anything
    strides = [s if n > 1 else 0 for t in (q, k, v, o) for s, n in zip(t.stride()[:3], t.shape)]
    if q.dtype == torch.bfloat16:
        check_aligned("attention", (q, k, v, o), strides)
    lens = lengths.to(torch.int32).contiguous() if lengths is not None else None
    offs = row_offsets.to(torch.int32).contiguous() if row_offsets is not None else None
    strides = (ctypes.c_longlong * 12)(*strides)
    lib = _build.library("attention")
    rc = lib.uv_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), strides,
        B, H, H // Hkv, T, S, D, scale * LOG2E, _build.ptr(lens), _build.ptr(offs),
        int(causal), int(latency_block), _build.dtype_code(q), _build.stream_ptr(q.device),
    )
    _build.check("attention", rc)


def attention_headmajor(
    qkv_t: torch.Tensor,  # (B, 3H, T, D)
    lengths: torch.Tensor,  # (B,) valid keys
    *,
    n_heads: int,
    scale: Optional[float] = None,
    latency_block: int = 0,
) -> torch.Tensor:
    """Encoder self-attention over the packed head-major array (q, k, v at
    head offsets 0, H, 2H), key-length mask and optional block-causal
    latency mask. Returns (B, H, T, D)."""
    B, G, T, D = qkv_t.shape
    H = n_heads
    if G != 3 * H:
        raise ValueError(f"expected {3 * H} packed heads, got {G}")
    if scale is None:
        scale = D**-0.5
    q, k, v = qkv_t[:, :H], qkv_t[:, H : 2 * H], qkv_t[:, 2 * H :]
    if qkv_t.device.type == "cpu":
        return attention_plain(q, k, v, lengths, scale=scale, latency_block=latency_block)
    out = torch.empty((B, H, T, D), dtype=qkv_t.dtype, device=qkv_t.device)
    _launch_attention(q, k, v, out, lengths, None, scale, False, latency_block)
    attention_headmajor.launches += 1
    return out


attention_headmajor.launches = 0


def fused_attention(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    lengths: Optional[torch.Tensor] = None,  # (B,) valid key length
    row_offsets: Optional[torch.Tensor] = None,  # (B,) absolute pos of row 0
    *,
    scale: Optional[float] = None,
    causal: bool = False,
    latency_block: int = 0,
) -> torch.Tensor:
    """Attention with GQA and scalar masks. Returns (B, T, H, D)."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D**-0.5
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if q.device.type == "cpu":
        out = attention_plain(
            qh, kh, vh, lengths, row_offsets, scale=scale, causal=causal,
            latency_block=latency_block,
        )
        return out.transpose(1, 2)
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    _launch_attention(
        qh, kh, vh, out.transpose(1, 2), lengths, row_offsets, scale, causal, latency_block
    )
    fused_attention.launches += 1
    return out


fused_attention.launches = 0

