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
for CUDA tensors: one launch per call at every shape
(``decode_matmul.launches`` counts calls). ``_plan`` picks the kernel's
instance and how K is split; it is pure Python, so the CPU tests hold it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ultravox_torch.ops.kernels import _build

MAX_ROWS = 32
SUM_ROWS = (1, 4, 8, 16, 32)  # row counts the fp32-x kernel keeps sums for
MMA_ROWS = (8, 16, 32)  # rows of x the bf16-x (tensor-core) kernel pads M to
MAX_SUMS = 32  # fp32 sums per lane on the CUDA cores: rows x columns
W_CODES = {torch.bfloat16: 1, torch.int8: 2}  # csrc/decode_matmul.cu
WARPS = 4  # warps a block, each streaming its own run of K rows
ROUND = 16  # K rows a warp takes per round; a warp's run is a multiple
MAX_CLUSTER = 8  # blocks a cluster (the portable limit), splitting K


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
class Plan(NamedTuple):
    rows: int  # sum rows (at least M): 8/16/32 on the tensor cores, else 1-32
    cols: int  # weight columns a lane holds
    vec: bool  # whether a lane's columns load as one vector
    warps_n: int  # warps of a block side by side along N (1 or 4); the others split K
    tile: int  # weight columns a block (and its cluster) covers
    cluster: int  # blocks a cluster, which split K (1 to MAX_CLUSTER)
    k_warp: int  # K rows a warp streams (a multiple of ROUND)


def _plan(M: int, K: int, N: int, w_size: int, w_ptr: int, mma: bool, sms: int,
          cluster: Optional[int] = None, warps_n: Optional[int] = None) -> Plan:
    """The kernel's instance and K split for x (M, K) times w (K, N) of
    ``w_size``-byte elements at address ``w_ptr``. ``mma``: bf16 x (the
    tensor-core kernel; a lane holds 8 bf16 or 16 int8 columns, 8 int8 at
    32 rows); else fp32 x (the CUDA-core kernel; a lane holds at most 16
    bytes and 32 sums). A ragged N or a weight address off the vector's
    alignment loads element by element (tensor cores) or one column a lane
    (CUDA cores). Then K is split over a cluster of up to 8 blocks and over
    the block's warps that are not side by side along N; each warp's run of
    K is a whole number of 16-row rounds. ``cluster`` forces the cluster
    size (as far as K allows it), ``warps_n`` the block's warps along N
    (where the instance has that width)."""
    if mma:
        rows = next(r for r in MMA_ROWS if M <= r)
        cols = 16 // w_size if rows < 32 else 8
        vec = N % cols == 0 and w_ptr % (cols * w_size) == 0
        # int8 whose 128-column tiles give under 4 blocks per SM even in
        # clusters of 8: 64-column tiles, twice the blocks
        if vec and cols == 16 and -(-N // 128) * MAX_CLUSTER < 4 * sms:
            cols = 8
        warp_cols = 8 * cols
    else:
        rows = next(t for t in SUM_ROWS if M <= t)
        cols = min(16 // w_size, MAX_SUMS // rows)
        vec = N % cols == 0 and w_ptr % (cols * w_size) == 0
        if not vec:
            cols = 1
        warp_cols = 32 * cols
    rounds = -(-K // ROUND)
    # The smallest cluster (1, 2, 4 or 8: 3, 5, 6 and 7 measured slower than
    # 4 or 8), then the widest block (its 4 warps read one run of each
    # weight row side by side; bf16 x with vector loads only), that gives
    # the card 1.5 blocks per SM; else clusters of 8 one warp wide. Fewer and
    # longer runs of K stream faster, and a cluster costs more to launch and
    # merge the larger it is.
    widths = (4, 1) if mma and vec else (1,)
    if warps_n is not None and warps_n in widths:
        widths = (warps_n,)
    clusters = (1, 2, 4, 8) if cluster is None else (cluster,)
    shapes = [(cl, wn) for cl in clusters for wn in widths]
    for cl, warps_n in shapes:
        cl = max(1, min(cl, -(-rounds // (WARPS // warps_n))))
        tile = warps_n * warp_cols
        if -(-N // tile) * cl * 2 >= 3 * sms:
            break
    parts = WARPS // warps_n
    k_warp = ROUND * -(-rounds // (cl * parts))
    cl = -(-K // (parts * k_warp))
    return Plan(rows, cols, vec, warps_n, tile, cl, k_warp)


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
    plan = _plan(M, K, N, w.element_size(), w.data_ptr(), x.dtype == torch.bfloat16,
                 _build.sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _build.library("decode_matmul")
    rc = lib.uv_decode_matmul(
        _build.ptr(x), x.stride(0), _build.dtype_code(x), _build.ptr(w), W_CODES[w.dtype],
        _build.ptr(scale), scale_code, _build.ptr(out), _build.DTYPE_CODES[out_dtype],
        M, K, N, plan.rows, plan.cols, int(plan.vec), plan.warps_n, plan.cluster, plan.k_warp,
        _build.stream_ptr(x.device),
    )
    _build.check("decode_matmul", rc)
    decode_matmul.launches += 1
    return out


decode_matmul.launches = 0
