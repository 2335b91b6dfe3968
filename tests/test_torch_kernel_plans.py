"""The host-side plans of the CUDA kernels' wrappers, as pure Python.

``decode_matmul._plan`` picks #14's instance (sum rows, weight columns a
lane, vector or element loads, warps side by side along N) and how K is
split over a thread-block cluster and the block's warps;
``layer_norm._plan`` picks #1's instance (16-byte or element pieces, how
many a lane holds, or a block per row); ``fused_attention._plan`` picks
#2's kernel (the tensor-core tile or the CUDA-core row tile) and its rows,
``_transpose_plan`` #5's tile, and ``_gelu_plan`` and ``_out_proj_plan``
#6's and #7's kernel, rows and column tiles a block.
The kernels run only on the card (tests/test_torch_cuda.py holds them
there); what they are told to do is checked here: every K row (#14) or
output element (#2, #6, #7) covered exactly once, the cluster within the portable
limit, the vector width dividing N and the pointer's alignment, shared
memory within a block's limit, and an instance that the CUDA source
dispatches.
"""

import pytest
import torch

from ultravox_torch.ops.kernels import decode_matmul as dm
from ultravox_torch.ops.kernels import fused_attention as fa
from ultravox_torch.ops.kernels import layer_norm as ln

SMS = 132  # an H100 SXM
# Llama-3.2-1B's decoder products, ragged and small shapes, a long K
SHAPES = [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048), (2048, 128256),
          (300, 1001), (1000, 8704), (64, 96), (1, 7), (4096, 640)]
ROW_COUNTS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32]


def _dispatched(w_size, mma, plan) -> bool:
    """Whether csrc/decode_matmul.cu has the instance the plan names."""
    if not mma:
        vec_cols = min(16 // w_size, dm.MAX_SUMS // plan.rows)
        return (plan.rows in dm.SUM_ROWS and plan.cols in (1, vec_cols)
                and plan.warps_n == 1)
    if plan.rows not in dm.MMA_ROWS or plan.warps_n not in ((1, 4) if plan.vec else (1,)):
        return False
    if w_size == 2:
        return plan.cols == 8
    if plan.cols == 16:
        return plan.rows in (8, 16)
    return plan.cols == 8 and (plan.vec or plan.rows == 32)


def _check_plan(M, K, N, w_size, w_ptr, mma, plan):
    assert plan.rows >= M
    assert 1 <= plan.cluster <= dm.MAX_CLUSTER  # the portable cluster size
    assert plan.k_warp > 0 and plan.k_warp % dm.ROUND == 0
    assert plan.tile == plan.warps_n * (8 if mma else 32) * plan.cols
    if plan.vec:  # one vector a lane: N and the address allow its width
        assert N % plan.cols == 0 and w_ptr % (plan.cols * w_size) == 0
    if not mma:
        assert plan.rows * plan.cols <= dm.MAX_SUMS and plan.cols * w_size <= 16
    assert _dispatched(w_size, mma, plan), plan
    # every K row exactly once: the runs of the cluster's ranks and each
    # block's K parts tile [0, K) in order, and no rank is left without rows
    parts = dm.WARPS // plan.warps_n
    covered = []
    for rank in range(plan.cluster):
        starts = [(rank * parts + wk) * plan.k_warp for wk in range(parts)]
        assert starts[0] < K, "a rank of the cluster gets no rows"
        for r0 in starts:
            covered.extend(range(min(K, r0), min(K, r0 + plan.k_warp)))
    assert covered == list(range(K))


@pytest.mark.parametrize("mma", [True, False], ids=["bf16-x", "fp32-x"])
@pytest.mark.parametrize("w_size", [2, 1], ids=["bf16-w", "int8-w"])
@pytest.mark.parametrize("kn", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_matmul_plan_covers_k_once(kn, w_size, mma):
    K, N = kn
    for M in ROW_COUNTS:
        for w_ptr in (0, 2, 8, 1 << 20):
            if w_ptr % w_size:
                continue
            _check_plan(M, K, N, w_size, w_ptr, mma, dm._plan(M, K, N, w_size, w_ptr, mma, SMS))


@pytest.mark.parametrize("warps_n", [1, 4])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 5, 6, 7, 8])
def test_decode_matmul_plan_takes_a_forced_shape(cluster, warps_n):
    """A forced cluster and width (the CUDA tests sweep them) are kept as
    far as K and the instance allow, and still cover K once."""
    for w_size in (2, 1):
        for M in (4, 17):
            for mma in (True, False):
                plan = dm._plan(M, 4096, 640, w_size, 0, mma, SMS, cluster=cluster, warps_n=warps_n)
                assert plan.cluster == cluster
                assert plan.warps_n == (warps_n if mma else 1)
                _check_plan(M, 4096, 640, w_size, 0, mma, plan)
    # K of 48 rows: 3 rounds of 16, so no more ranks than the rounds a
    # block's K parts leave (4 warps deep: one rank)
    plan = dm._plan(4, 48, 640, 2, 0, True, SMS, cluster=cluster, warps_n=warps_n)
    assert plan.cluster == min(cluster, -(-3 // (dm.WARPS // warps_n)))
    _check_plan(4, 48, 640, 2, 0, True, plan)


@pytest.mark.parametrize("w_size,cluster,warps_n,tile", [
    (2, 8, 1, 64),    # qkv_proj: a small N takes the 8-way split
    (1, 8, 1, 64),    # int8 at qkv_proj: 64-column tiles, for enough blocks
])
def test_decode_matmul_plan_small_product(w_size, cluster, warps_n, tile):
    plan = dm._plan(4, 2048, 3072, w_size, 0, True, SMS)
    assert (plan.cluster, plan.warps_n, plan.tile) == (cluster, warps_n, tile)


def test_decode_matmul_plan_large_products():
    """A large product streams with few K splits; the lm_head's wide tiles
    put a block's 4 warps side by side along N."""
    gateup = dm._plan(4, 2048, 16384, 2, 0, True, SMS)
    assert (gateup.cluster, gateup.warps_n) == (1, 1)
    head = dm._plan(4, 2048, 128256, 2, 0, True, SMS)
    assert (head.cluster, head.warps_n, head.tile) == (1, 4, 256)
    head8 = dm._plan(4, 2048, 128256, 1, 0, True, SMS)
    assert (head8.cluster, head8.warps_n, head8.cols) == (1, 4, 16)


LN_DIMS = [1, 7, 77, 128, 200, 256, 257, 768, 1000, 1280, 3000, 4096, 4097, 5000, 56 * 1024]


@pytest.mark.parametrize("elem_size", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", LN_DIMS)
def test_layer_norm_plan_matches_d(D, elem_size):
    """A warp a row up to D 4096, with the fewest pieces that cover D:
    16-byte pieces where D and every pointer allow them, else elements;
    past 4096 a block a row."""
    aligned = (0, 4096, 8192, 12288)
    for ptrs in (aligned, (elem_size,) + aligned[1:], aligned[:3] + (4,)):
        vec, pieces = ln._plan(D, elem_size, ptrs)
        if D > ln.MAX_WARP_D:
            assert (vec, pieces) == (False, 0)
            continue
        per = 16 // elem_size
        assert vec == (D % per == 0 and all(p % 16 == 0 for p in ptrs))
        width = per if vec else 1
        assert pieces in ln.WARP_PIECES[width]
        assert 32 * width * pieces >= D
        smaller = [n for n in ln.WARP_PIECES[width] if n < pieces]
        assert not smaller or 32 * width * max(smaller) < D


def test_layer_norm_plan_encoder_width():
    """The encoder's 768 columns: 3 16-byte pieces a lane in bf16, 6 in fp32."""
    assert ln._plan(768, 2, (0, 16, 32, 48)) == (True, 3)
    assert ln._plan(768, 4, (0, 16, 32, 48)) == (True, 6)
    assert ln._plan(768, 2, (2, 16, 32, 48)) == (False, 32)


# #2 ln_qkv_head_fused's plan: (rows, D, C, head_dim)
LN_QKV_SHAPES = [(2000, 768, 2304, 64), (500, 768, 2304, 64), (4, 768, 2304, 64),
                 (154, 96, 288, 32), (1500, 1280, 3840, 64), (183, 784, 1544, 8),
                 (1, 16, 8, 8), (4100, 2048, 6144, 128)]
ALIGNED = (0, 4096, 8192, 12288, 16384)  # x, scale, bias, weight, output


def _ln_qkv_cover(plan, rows, C):
    """Every (row, 16-byte line of columns) the grid stores, as the kernel's
    epilogue walks its tiles; each must come once."""
    seen = []
    for by in range(-(-rows // plan.bm)):
        for bx in range(-(-C // plan.bn)):
            for r in range(plan.bm):
                for c in range(plan.bn // 8):
                    row, n = by * plan.bm + r, bx * plan.bn + c * 8
                    if row < rows and n < C:
                        seen.append((row, n))
    return seen


@pytest.mark.parametrize("shape", LN_QKV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ln_qkv_head_plan_routes(shape):
    """bf16 with D % 16, C % 8, Dh % 8 and 16-byte-aligned pointers takes
    the tensor cores; fp32, an unaligned pointer or a D, C or head_dim off
    those multiples takes the CUDA-core row tile, as before."""
    rows, D, C, Dh = shape
    plan = fa._plan(True, rows, D, C, Dh, ALIGNED)
    assert plan.mma and plan.bn == fa.MMA_BN and plan.bm in fa.MMA_ROWS
    assert plan.smem == fa.mma_smem_bytes(plan.bm, D) <= fa.MAX_SMEM
    assert not fa._plan(False, rows, D, C, Dh, ALIGNED).mma
    for i in range(len(ALIGNED)):
        off = ALIGNED[:i] + (ALIGNED[i] + 2,) + ALIGNED[i + 1:]
        assert not fa._plan(True, rows, D, C, Dh, off).mma
    assert not fa._plan(True, rows, D + 8, C, Dh, ALIGNED).mma  # D % 16 == 8
    assert not fa._plan(True, rows, D, C + 4, Dh, ALIGNED).mma  # C % 8 == 4
    cuda_core = fa._plan(True, rows, D, C, Dh, ALIGNED[:1] + (2,) + ALIGNED[2:])
    assert (cuda_core.bm, cuda_core.bn, cuda_core.smem) == (32, 128, (32 * D + 32 * 128) * 4)


@pytest.mark.parametrize("shape", LN_QKV_SHAPES[:6], ids=lambda s: "x".join(map(str, s)))
def test_ln_qkv_head_plan_covers_every_output_once(shape):
    """The grid's tiles store every output row and 16-byte line of columns
    exactly once, for the chosen tile and for every tile that fits."""
    rows, D, C, Dh = shape
    want = [(r, n) for r in range(rows) for n in range(0, C, 8)]
    plans = [fa._plan(True, rows, D, C, Dh, ALIGNED)]
    plans += [fa._plan(True, rows, D, C, Dh, ALIGNED, bm=m) for m in fa.MMA_ROWS
              if fa.mma_smem_bytes(m, D) <= fa.MAX_SMEM]
    for plan in plans:
        assert sorted(_ln_qkv_cover(plan, rows, C)) == want


def test_ln_qkv_head_plan_fits_shared_memory_for_every_width():
    """Every D up to ROW_TILE_MAX_K (and the tile's own limit) is planned
    within the 232448 bytes a block may use, on either kernel; every bf16
    D % 16 == 0 up to MMA_MAX_D takes the tensor cores."""
    for D in range(8, max(fa.ROW_TILE_MAX_K, fa.MMA_MAX_D) + 1, 8):
        plan = fa._plan(True, 2000, D, 2304, 64, ALIGNED)
        assert plan.mma == (D % 16 == 0 and D <= fa.MMA_MAX_D), D
        if plan.mma or D <= fa.ROW_TILE_MAX_K:
            assert plan.smem <= 232448, (D, plan)
        if plan.mma:
            assert plan.smem == fa.mma_smem_bytes(plan.bm, D)
    with pytest.raises(ValueError, match="cannot run"):
        fa._plan(True, 2000, 1280, 3840, 64, ALIGNED, bm=128)  # 128 rows of 1280 do not fit


@pytest.mark.parametrize("rows,bm,blocks", [
    (2000, 128, 18 * 16),  # the flagship encoder at 4 requests: (4, 500, 768)
    (500, 128, 18 * 4),    # at one request (a serving admission)
    (4, 32, 18),           # a single frame at 4 requests
    (1500, 128, 18 * 12),  # 30 s of audio at one request
])
def test_ln_qkv_head_plan_grid_at_the_flagship(rows, bm, blocks):
    """(768 -> 2304): the fewest tile rows that hold every row, else 128,
    in 128-column tiles; the grid's block count."""
    plan = fa._plan(True, rows, 768, 2304, 64, ALIGNED)
    assert plan.mma and plan.bm == bm and plan.bn == 128
    assert -(-rows // plan.bm) * -(-2304 // plan.bn) == blocks


# #5 qkv_head_transpose's plan: (B, T, G, head_bytes). The flagship
# encoder at one request and at four (36 heads of 64 bf16), a single frame,
# a ragged T with fp32 heads of 128, a T no row count divides, and heads so
# wide that one row of them does not fit a block's shared memory.
TRANSPOSE_SHAPES = [(1, 500, 36, 128), (4, 500, 36, 128), (1, 1, 36, 128), (2, 77, 6, 512),
                    (4, 501, 36, 128), (3, 13, 7, 256), (1, 3, 600, 512)]


def _transpose_copies(plan, B, T, G, hb):
    """What csrc/qkv_head_transpose.cu moves for the plan, as (input byte
    offset, output byte offset) per 16-byte unit: each block's bulk copies
    (one per row, of its heads' bytes, into shared memory [r][g][d]; their
    sum is the barrier's count) and its threads' stores (unit j of head g's
    rows * units span from shared unit (j // units, g, j % units))."""
    units, moved = hb // 16, []
    for b in range(B):
        for gy in range(-(-G // plan.heads)):
            for bx in range(-(-T // plan.rows)):
                t0, g0 = bx * plan.rows, gy * plan.heads
                rows, heads = min(plan.rows, T - t0), min(plan.heads, G - g0)
                row_bytes, src0 = heads * hb, ((b * T + t0) * G + g0) * hb
                tile = {}  # shared-memory offset -> input offset
                for r in range(rows):
                    for u in range(0, row_bytes, 16):
                        tile[r * row_bytes + u] = src0 + r * G * hb + u
                assert len(tile) * 16 == rows * row_bytes  # expect_tx's count
                assert max(tile) + 16 <= plan.smem
                dst0, span = ((b * G + g0) * T + t0) * hb, rows * units
                for e in range(heads * span):
                    g, j = divmod(e, span)
                    r, d = divmod(j, units)
                    src = tile[((r * heads + g) * units + d) * 16]
                    moved.append((src, dst0 + g * T * hb + j * 16))
    return moved


@pytest.mark.parametrize("rows", [None, 1, 3, 16])
@pytest.mark.parametrize("shape", TRANSPOSE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_qkv_head_transpose_plan_copies_every_unit_once(shape, rows):
    """Every 16-byte unit of the input is read once and lands once, where
    (B, T, G, d) -> (B, G, T, d) puts it; each block's tile fits its shared
    memory and the grid's limits."""
    B, T, G, hb = shape
    plan = fa._transpose_plan(B, T, G, hb, SMS, rows=rows)
    assert plan.smem == plan.rows * plan.heads * hb <= fa.MAX_SMEM - 16
    assert plan.blocks == B * -(-T // plan.rows) * -(-G // plan.heads)
    assert -(-G // plan.heads) <= 65535 and B <= 65535
    units = {}
    for src, dst in _transpose_copies(plan, B, T, G, hb):
        assert src % 16 == 0 and dst % 16 == 0 and dst not in units
        units[dst] = src
    assert len(units) == B * T * G * hb // 16
    assert sorted(units.values()) == list(range(0, B * T * G * hb, 16))  # each read once
    for dst, src in units.items():  # out[b, g, t, d] = in[b, t, g, d]
        b, rest = divmod(dst, G * T * hb)
        g, rest = divmod(rest, T * hb)
        t, d = divmod(rest, hb)
        assert src == ((b * T + t) * G + g) * hb + d


@pytest.mark.parametrize("B,rows,blocks", [(1, 1, 500), (4, 4, 500)])
def test_qkv_head_transpose_plan_at_the_flagship(B, rows, blocks):
    """(B, 500, 36 heads of 64 bf16): the most rows that still give every
    SM two blocks, all heads in one block; one block's tile well within
    shared memory."""
    plan = fa._transpose_plan(B, 500, 36, 128, SMS)
    assert (plan.rows, plan.heads, plan.blocks) == (rows, 36, blocks)
    assert plan.blocks >= fa.TRANSPOSE_BLOCKS_PER_SM * SMS
    assert plan.smem == rows * 36 * 128


def test_qkv_head_transpose_plan_splits_heads_that_do_not_fit():
    """600 fp32 heads of 128 are 307,200 bytes a row: more than a block's
    232,448, so the heads split into groups that fit."""
    plan = fa._transpose_plan(1, 3, 600, 512, SMS)
    assert plan.heads < 600 and plan.smem <= fa.MAX_SMEM - 16
    forced = fa._transpose_plan(1, 3, 600, 512, SMS, rows=16)
    assert forced.heads == (fa.MAX_SMEM - 16) // (16 * 512)


# #6 ln_matmul_gelu's plan: (rows, D, F). The encoder's fc1 at 4 requests
# and at one, a single frame, a ragged shape, whisper-large's FFN (the JAX
# note's bench shape), a D past 3 pieces a lane, and the widest D.
GELU_SHAPES = [(2000, 768, 3072), (500, 768, 3072), (4, 768, 3072), (154, 96, 384),
               (1500, 1280, 5120), (183, 784, 1544), (1, 16, 8), (4100, 2048, 6144)]


def _gelu_cover(plan, rows, F):
    """Every (row, 16-byte line of columns) the grid stores: block (bx, by)
    runs column tiles bx * tiles .. + tiles of rows by * bm .. + bm."""
    col_tiles = -(-F // plan.bn)
    seen = []
    for by in range(-(-rows // plan.bm)):
        for bx in range(-(-col_tiles // plan.tiles)):
            for c in range(bx * plan.tiles, min(bx * plan.tiles + plan.tiles, col_tiles)):
                for r in range(plan.bm):
                    for piece in range(plan.bn // 8):
                        row, n = by * plan.bm + r, c * plan.bn + piece * 8
                        if row < rows and n < F:
                            seen.append((row, n))
    return seen


@pytest.mark.parametrize("shape", GELU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ln_matmul_gelu_plan_routes(shape):
    """bf16 with D % 16, F % 8 and 16-byte-aligned pointers takes the
    tensor cores; fp32, an unaligned pointer or a D or F off those
    multiples takes the CUDA-core row tile, as before."""
    rows, D, F = shape
    plan = fa._gelu_plan(True, rows, D, F, ALIGNED, SMS)
    assert plan.mma and plan.bn == fa.MMA_BN and plan.bm in fa.MMA_ROWS
    assert 1 <= plan.tiles <= -(-F // fa.MMA_BN)
    assert plan.smem == fa.mma_smem_bytes(plan.bm, D) <= fa.MAX_SMEM
    assert plan.bm == fa._plan(True, rows, D, F, 8, ALIGNED).bm  # #2's rows
    assert not fa._gelu_plan(False, rows, D, F, ALIGNED, SMS).mma
    for i in range(len(ALIGNED)):
        off = ALIGNED[:i] + (ALIGNED[i] + 2,) + ALIGNED[i + 1:]
        assert not fa._gelu_plan(True, rows, D, F, off, SMS).mma
    assert not fa._gelu_plan(True, rows, D + 8, F, ALIGNED, SMS).mma  # D % 16 == 8
    assert not fa._gelu_plan(True, rows, D, F + 4, ALIGNED, SMS).mma  # F % 8 == 4
    cuda_core = fa._gelu_plan(True, rows, D, F, ALIGNED[:1] + (2,) + ALIGNED[2:], SMS)
    assert cuda_core == fa.TilesPlan(False, 32, 128, 1, (32 * D + 32 * 128) * 4)


@pytest.mark.parametrize("shape", GELU_SHAPES[1:7], ids=lambda s: "x".join(map(str, s)))
def test_ln_matmul_gelu_plan_covers_every_output_once(shape):
    """The grid stores every output row and 16-byte line of columns exactly
    once, for the chosen plan and for every tile and column-tile count
    forced."""
    rows, D, F = shape
    want = [(r, n) for r in range(rows) for n in range(0, F, 8)]
    plans = [fa._gelu_plan(True, rows, D, F, ALIGNED, SMS)]
    for m in fa.MMA_ROWS:
        if fa.mma_smem_bytes(m, D) <= fa.MAX_SMEM:
            plans += [fa._gelu_plan(True, rows, D, F, ALIGNED, SMS, bm=m, tiles=k)
                      for k in (1, 2, 3, 5, 64)]
    for plan in plans:
        assert sorted(_gelu_cover(plan, rows, F)) == want, plan


def test_ln_matmul_gelu_plan_fits_shared_memory_for_every_width():
    """Every D the wrapper takes (up to ROW_TILE_MAX_K) is planned within
    the 232448 bytes a block may use, on either kernel; a tile that does
    not fit raises."""
    for D in range(8, fa.ROW_TILE_MAX_K + 1, 8):
        plan = fa._gelu_plan(True, 2000, D, 3072, ALIGNED, SMS)
        assert plan.mma == (D % 16 == 0), D
        assert plan.smem <= 232448, (D, plan)
    with pytest.raises(ValueError, match="cannot run"):
        fa._gelu_plan(True, 1500, 1280, 5120, ALIGNED, SMS, bm=128)
    with pytest.raises(ValueError, match="cannot run"):
        fa._gelu_plan(True, 2000, 768, 3072, ALIGNED, SMS, tiles=0)


@pytest.mark.parametrize("rows,bm,tiles,blocks", [
    (2000, 128, 3, 16 * 8),  # fc1 at 4 requests: one wave of 128 blocks, 3 tiles each
    (500, 128, 1, 4 * 24),   # at one request: 96 blocks, one tile each
    (4, 32, 1, 24),          # a single frame at 4 requests
])
def test_ln_matmul_gelu_plan_grid_at_fc1(rows, bm, tiles, blocks):
    """(768 -> 3072): #2's tile rows; the column tiles a block runs where
    the grid's waves times (tiles + one LayerNorm) is least."""
    plan = fa._gelu_plan(True, rows, 768, 3072, ALIGNED, SMS)
    assert plan.mma and (plan.bm, plan.tiles) == (bm, tiles)
    assert -(-rows // plan.bm) * -(-24 // plan.tiles) == blocks


def test_ln_matmul_gelu_plan_at_whisper_large():
    """(1, 1500, 1280) x (1280, 5120): only 64- and 32-row tiles fit at
    D 1280, as for #2; 24 row tiles x 40 column tiles on 132 SMs."""
    plan = fa._gelu_plan(True, 1500, 1280, 5120, ALIGNED, SMS)
    assert plan.mma and plan.bm == 64
    assert 24 * -(-40 // plan.tiles) <= SMS  # one wave


# #7 attn_out_proj_residual's plan: (rows, H, Dh, M). The encoder's
# out-projection at 4 requests and at one, a single frame, whisper-large's,
# Llama-3.2-1B's o_proj width (32 heads of 64), a ragged T with a
# column-tile tail, heads of 128, and small heads of 8 into 136 columns.
OUT_PROJ_SHAPES = [(2000, 12, 64, 768), (500, 12, 64, 768), (4, 12, 64, 768),
                   (1500, 20, 64, 1280), (2000, 32, 64, 2048), (1002, 12, 64, 520),
                   (154, 6, 128, 768), (77, 2, 8, 136)]
OUT_PROJ_ALIGNED = (0, 4096, 8192, 12288)  # attn, weight, residual, output


@pytest.mark.parametrize("shape", OUT_PROJ_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attn_out_proj_plan_routes(shape):
    """bf16 with K = H * Dh % 16 == 0 (up to 2048), Dh % 8, M % 8 and
    16-byte-aligned pointers takes the tensor cores; fp32, an unaligned
    pointer, or a Dh, M or K off those multiples takes the CUDA-core row
    tile."""
    rows, H, Dh, M = shape
    K = H * Dh
    plan = fa._out_proj_plan(True, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS)
    assert plan.mma and plan.bn == fa.MMA_BN and plan.bm in fa.MMA_ROWS
    assert 1 <= plan.tiles <= -(-M // fa.MMA_BN)
    assert plan.smem == fa.mma_smem_bytes(plan.bm, K, ln=False) <= fa.MAX_SMEM
    assert not fa._out_proj_plan(False, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS).mma
    for i in range(len(OUT_PROJ_ALIGNED)):
        off = OUT_PROJ_ALIGNED[:i] + (OUT_PROJ_ALIGNED[i] + 2,) + OUT_PROJ_ALIGNED[i + 1:]
        assert not fa._out_proj_plan(True, rows, H, Dh, M, off, SMS).mma
    assert not fa._out_proj_plan(True, rows, 4, 12, M, OUT_PROJ_ALIGNED, SMS).mma  # Dh % 8, K 48
    assert not fa._out_proj_plan(True, rows, H, Dh, M + 4, OUT_PROJ_ALIGNED, SMS).mma  # M % 8
    assert not fa._out_proj_plan(True, rows, 1, 8, M, OUT_PROJ_ALIGNED, SMS).mma  # K % 16 == 8
    cuda_core = fa._out_proj_plan(True, rows, H, Dh, M, OUT_PROJ_ALIGNED[:1] + (2,) +
                                  OUT_PROJ_ALIGNED[2:], SMS)
    assert cuda_core == fa.TilesPlan(False, 32, 128, 1, (32 * K + 32 * 128) * 4)


@pytest.mark.parametrize("shape", OUT_PROJ_SHAPES[1:4] + OUT_PROJ_SHAPES[5:],
                         ids=lambda s: "x".join(map(str, s)))
def test_attn_out_proj_plan_covers_every_output_once(shape):
    """The grid stores every output row and 16-byte line of columns exactly
    once, for the chosen plan and for every tile and column-tile count that
    can be forced; a tile that does not fit raises."""
    rows, H, Dh, M = shape
    want = [(r, n) for r in range(rows) for n in range(0, M, 8)]
    plans = [fa._out_proj_plan(True, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS)]
    for m in fa.MMA_ROWS:
        if fa.mma_smem_bytes(m, H * Dh, ln=False) > fa.MAX_SMEM:
            with pytest.raises(ValueError, match="cannot run"):
                fa._out_proj_plan(True, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS, bm=m)
            continue
        with pytest.raises(ValueError, match="cannot run"):  # no tensor-core route in fp32
            fa._out_proj_plan(False, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS, bm=m)
        plans += [fa._out_proj_plan(True, rows, H, Dh, M, OUT_PROJ_ALIGNED, SMS, bm=m, tiles=k)
                  for k in (1, 2, 3, 5, 64)]
    for plan in plans:  # the grid walks its tiles as #6's does
        assert sorted(_gelu_cover(plan, rows, M)) == want, plan


def _mma_rows_constants():
    """The constants of csrc/mma_rows.cuh that its smem_bytes reads."""
    import re
    from pathlib import Path

    src = (Path(fa.__file__).parent / "csrc" / "mma_rows.cuh").read_text()
    return {name: int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src).group(1))
            for name in ("BK", "STAGES", "kMaxK", "kMaxSmem")}


def test_attn_out_proj_plan_fits_shared_memory_for_every_width():
    """mma_smem_bytes reckons with csrc/mma_rows.cuh's constants (with and
    without the LN vectors), and every K % 16 == 0 up to its widest row is
    planned within a block's shared memory on the tensor cores, with the
    rows that fit; past it, the CUDA-core tile."""
    c = _mma_rows_constants()
    assert (fa.RING_ROWS, fa.RING_STAGES, fa.MMA_MAX_D, fa.MAX_SMEM) == (
        c["BK"], c["STAGES"], c["kMaxK"], c["kMaxSmem"])
    for K in range(16, c["kMaxK"] + 1, 16):
        for bm in fa.MMA_ROWS:
            main = bm * (K + 8) + c["STAGES"] * c["BK"] * (fa.MMA_BN + 8)
            body = 2 * max(main, bm * (fa.MMA_BN + 8))
            assert fa.mma_smem_bytes(bm, K, ln=False) == body
            assert fa.mma_smem_bytes(bm, K) == 8 * K + body
        plan = fa._out_proj_plan(True, 2000, K // 16, 16, 768, OUT_PROJ_ALIGNED, SMS)
        assert plan.mma and plan.smem <= c["kMaxSmem"], (K, plan)
        assert fa.mma_smem_bytes(plan.bm, K, ln=False) == plan.smem
    assert not fa._out_proj_plan(True, 2000, 33, 64, 768, OUT_PROJ_ALIGNED, SMS).mma  # K 2112
    assert [m for m in fa.MMA_ROWS if fa.mma_smem_bytes(m, 2048, ln=False) <= fa.MAX_SMEM] == [32]


@pytest.mark.parametrize("rows,H,M,bm,tiles,blocks", [
    (2000, 12, 768, 128, 1, 16 * 6),  # (4, 12, 500, 64) x 768: one wave of 128-row tiles
    (500, 12, 768, 64, 1, 8 * 6),     # (1, 12, 500, 64): 64-row tiles, 48 blocks, not 24
    (1500, 20, 1280, 64, 2, 24 * 5),  # whisper-large: 64-row tiles, 2 column tiles a block
])
def test_attn_out_proj_plan_grid(rows, H, M, bm, tiles, blocks):
    """The tile rows and column tiles a block runs where the waves times
    the work of a block (its column tiles and its gather) is least: the
    fastest of every tile the card's sweep timed at these three shapes;
    the grid's block count. 32-row tiles cost as much as 64-row ones (2
    warps leave half an SM idle), so 64 rows win the tie at B 1."""
    plan = fa._out_proj_plan(True, rows, H, 64, M, OUT_PROJ_ALIGNED, SMS)
    assert plan.mma and (plan.bm, plan.tiles) == (bm, tiles)
    assert -(-rows // plan.bm) * -(-(-(-M // 128)) // plan.tiles) == blocks


def test_attn_out_proj_takes_2048_wide_rows_to_the_tensor_cores(monkeypatch):
    """A 32 x 64 = 2048-wide out-projection (Llama-3.2-1B's o_proj), past
    the CUDA-core tile's ROW_TILE_MAX_K, is no longer refused before the
    route is chosen: on tensors that stand in for the card's (the meta
    device, the CUDA check stubbed) the wrapper reaches _out_proj_plan,
    which routes bf16 to the tensor cores; the test stops it there, before
    any launch."""
    seen = []

    class Planned(Exception):
        pass

    def plan(*args, **kw):
        seen.append(fa._out_proj_plan.__wrapped__(*args, **kw))
        raise Planned

    plan.__wrapped__ = fa._out_proj_plan
    monkeypatch.setattr(fa, "_out_proj_plan", plan)
    monkeypatch.setattr(fa._build, "require_cuda", lambda *ts: None)
    monkeypatch.setattr(fa._build, "sm_count", lambda index: SMS)
    B, H, T, Dh, M = 1, 32, 4, 64, 2048
    assert H * Dh > fa.ROW_TILE_MAX_K
    meta = dict(device="meta", dtype=torch.bfloat16)
    with pytest.raises(Planned):
        fa.attn_out_proj_residual(torch.empty((B, H, T, Dh), **meta),
                                  torch.empty((H, Dh, M), **meta), torch.empty((M,), **meta),
                                  torch.empty((B, T, M), **meta))
    assert len(seen) == 1 and seen[0].mma and seen[0].bm == 32
