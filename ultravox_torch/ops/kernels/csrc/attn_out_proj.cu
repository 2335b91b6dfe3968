// Attention out-projection with the residual, in one kernel:
// x_res + (concat_heads(attn) @ W + b), attn (B, H, T, Dh) read in that
// layout, W (H, Dh, M), x_res and the output (B, T, M).
//
// Replaces ultravox_tpu/ops/pallas/fused_attention.py:attn_out_proj_residual
// (unwired in the reference; the port's encoder keeps its einsum). Rounding
// points follow it: fp32 sums over all heads, cast to x_res's dtype, + b in
// that dtype, then the residual added in that dtype. Any T (the
// reference's T % 128 is a TPU layout rule).
//
// Bound on the card: bytes at the flagship encoder's shape ((4, 12, 500,
// 64) x (12, 64, 768) + (4, 500, 768): 10.4 MB against 2.4 GFLOP, ~230
// flop/byte, under the bf16 ridge of ~295). Neither the concatenated heads
// nor the projection reach HBM. Two kernels, chosen on the host before the
// launch (ops/kernels/fused_attention.py:_out_proj_plan):
//
// attn_out_proj_mma_kernel<BM, 128> (bf16; K = H * Dh with K % 16 == 0,
// K <= 2048, Dh % 8 == 0, M % 8 == 0, 16-byte-aligned attn, w, x_res and
// out): csrc/mma_rows.cuh's tensor-core tile. A block gathers its BM rows
// of every head into the resident tile A (pitch K + 8) with 16-byte
// cp.async copies, each a run of 8 values of one head row (b and t worked
// out once per row; a tile may straddle two batch rows), and keeps them
// there while it runs `tiles` 128-column tiles in turn, each through the
// 3-stage cp.async weight ring into mma.sync with fp32 sums; the next
// tile's first weight stages are in flight while this tile's epilogue
// runs. cp.async group order: the gather's copies are issued first and
// committed as a group of their own, then mma_rows::prefetch commits weight
// stages 0 and 1. product's first wait (cp.async.wait_group STAGES - 2 = 1)
// leaves only the newest group in flight, stage 1, so the gather and
// stage 0 have landed (and its barrier publishes them) before A is read.
// The epilogue works from the accumulators (mma_rows::store_lines): the sum
// rounded to bf16, + bias in bf16; each lane holds whole 16-byte lines,
// adds the matching 16-byte lines of x_res (loaded before the tile's
// product, so their latency hides behind it) in fp32, rounds to bf16 and
// stores. A plain launch, no split K and no atomics: repeats are bit-equal.
//
// attn_out_proj_kernel<T> (fp32, and every other shape or alignment up to
// K = 1688): the CUDA-core 32 x 128 row tile of row_tile.cuh with fp32
// FMAs, as the port first wrote it; its results are unchanged.
#include "mma_rows.cuh"
#include "row_tile.cuh"

namespace {

using namespace row_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_out_proj_kernel(const T* __restrict__ attn, const T* __restrict__ w,
                     const T* __restrict__ bias, const T* __restrict__ x_res, T* __restrict__ out,
                     int rows, int Tlen, int H, int Dh, int M) {
  extern __shared__ __align__(16) float smem[];
  const int K = H * Dh;
  float* As = smem;           // BM x K   heads of the block's rows
  float* Ws = smem + BM * K;  // BK x BN  weight tile
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < BM * K; e += kThreads) {
    const int r = e / K, k = e % K, row = row0 + r;
    float v = 0.f;
    if (row < rows) {
      const int b = row / Tlen, t = row % Tlen, h = k / Dh, d = k % Dh;
      v = to_f32(attn[((static_cast<size_t>(b) * H + h) * Tlen + t) * Dh + d]);
    }
    As[e] = v;
  }
  __syncthreads();
  float acc[4][4];
  product(As, Ws, w, K, M, n0, acc);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n >= M) continue;
      const size_t i = static_cast<size_t>(row) * M + n;
      const float y = round_to<T>(round_to<T>(acc[r][c]) + to_f32(bias[n]));
      out[i] = from_f32<T>(to_f32(x_res[i]) + y);
    }
  }
}

template <typename T>
int launch(const void* attn, const void* w, const void* bias, const void* x_res, void* out,
           int B, int H, int Tlen, int Dh, int M, cudaStream_t stream) {
  const size_t smem = smem_bytes(H * Dh);
  cudaError_t e = cudaFuncSetAttribute(attn_out_proj_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = B * Tlen;
  dim3 grid((M + BN - 1) / BN, (rows + BM - 1) / BM);
  attn_out_proj_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(attn), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(x_res), static_cast<T*>(out), rows, Tlen, H, Dh, M);
  return cudaGetLastError();
}

using mma_tile::bf16;

// Rows [row0, row0 + BM) of the heads-concat of attn (B, H, T, Dh) into A
// (pitch K + 8), asynchronously: piece (r, h, c) is attn[b, h, t, 8c : 8c
// + 8] at A[r, h Dh + 8c], row0 + r = b T + t. A thread takes the pieces
// (r, c) = divmod(i, Dh / 8) for i = tid, tid + THREADS, ... and copies
// each for every head, so b and t are worked out once per row it takes;
// for one head, consecutive threads copy consecutive 16 bytes. Rows at or
// past `rows` are zero-filled. The caller commits.
template <int BM, int THREADS>
__device__ __forceinline__ void gather_heads(bf16* A, const bf16* __restrict__ attn, int row0,
                                             int rows, int Tlen, int H, int Dh) {
  const int pitch = H * Dh + 8, cp = Dh / 8;
  const size_t head = static_cast<size_t>(Tlen) * Dh;  // elements from one head to the next
  for (int i = threadIdx.x; i < BM * cp; i += THREADS) {
    const int r = i / cp, c = i - r * cp, row = row0 + r;
    const bool ok = row < rows;
    const int b = ok ? row / Tlen : 0, t = ok ? row - b * Tlen : 0;
    const bf16* src = attn + (static_cast<size_t>(b) * H * Tlen + t) * Dh + c * 8;
    bf16* dst = A + r * pitch + c * 8;
    for (int h = 0; h < H; ++h)
      mma_tile::cp_async16(dst + h * Dh, ok ? src + h * head : attn, ok);
  }
}

// This lane's 16-byte lines of x_res for a tile (mma_rows::store_lines'
// places), zero where a line lies outside the output
template <int BM, int BN>
__device__ __forceinline__ void load_residual(uint4 (&xr)[2][mma_rows::Tile<BM, BN>::kNT / 2],
                                              const bf16* __restrict__ x_res, int row0, int rows,
                                              int M, int n0) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int p = 0; p < mma_rows::Tile<BM, BN>::kNT / 2; ++p) {
      const int row = row0 + mma_rows::line_row<BM, BN>(mt);
      const int n = n0 + mma_rows::line_col<BM, BN>(p);
      xr[mt][p] = row < rows && n < M
                      ? __ldg(reinterpret_cast<const uint4*>(x_res + static_cast<size_t>(row) * M + n))
                      : make_uint4(0, 0, 0, 0);
    }
}

// One output tile from the accumulators: y = bf16(bf16(acc) + bias), then
// out = bf16(x_res + y), stored as 16-byte lines
template <int BM, int BN>
__device__ __forceinline__ void residual_store(
    const float (&acc)[2][mma_rows::Tile<BM, BN>::kNT][4],
    const uint4 (&xr)[2][mma_rows::Tile<BM, BN>::kNT / 2], const bf16* __restrict__ bias,
    bf16* __restrict__ out, int row0, int rows, int M, int n0) {
  constexpr int NT = mma_rows::Tile<BM, BN>::kNT;
  float b[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + mma_rows::acc_col<BM, BN>(nt, 0);  // M % 8 == 0: n + 1 < M too
    b[nt][0] = n < M ? __bfloat162float(bias[n]) : 0.f;
    b[nt][1] = n < M ? __bfloat162float(bias[n + 1]) : 0.f;
  }
  mma_rows::store_lines<BM, BN>(
      acc, [&](float a, int nt, int j) { return round_to<bf16>(round_to<bf16>(a) + b[nt][j]); },
      [&](int mt, int p, int r, int c, uint4 line) {
        const int row = row0 + r, n = n0 + c;
        if (row >= rows || n >= M) return;
        const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&line);
        const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&xr[mt][p]);
        uint4 o;
        uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 fy = __bfloat1622float2(y[t]), fx = __bfloat1622float2(x[t]);
          ow[t] = mma_tile::pack_bf16(fx.x + fy.x, fx.y + fy.y);
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * M + n) = o;
      });
}

template <int BM, int BN>
__global__ void __launch_bounds__(mma_rows::Tile<BM, BN>::kThreads)
attn_out_proj_mma_kernel(const bf16* __restrict__ attn, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, const bf16* __restrict__ x_res,
                         bf16* __restrict__ out, int rows, int Tlen, int H, int Dh, int M,
                         int tiles) {
  using TL = mma_rows::Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = H * Dh;
  bf16* A = reinterpret_cast<bf16*>(smem_raw);  // BM x (K + 8): the rows' heads
  bf16* ring = A + BM * (K + 8);
  const int row0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * tiles, c1 = min(c0 + tiles, (M + BN - 1) / BN);

  gather_heads<BM, TL::kThreads>(A, attn, row0, rows, Tlen, H, Dh);
  mma_tile::cp_async_commit();  // the gather's own group, older than every weight stage
  mma_rows::prefetch<BM, BN>(ring, w, K, M, c0 * BN);
  for (int c = c0; c < c1; ++c) {
    uint4 xr[2][TL::kNT / 2];
    load_residual<BM, BN>(xr, x_res, row0, rows, M, c * BN);
    float acc[2][TL::kNT][4];
    mma_rows::product<BM, BN>(acc, A, K, ring, w, M, c * BN);  // ends with the ring free
    if (c + 1 < c1) mma_rows::prefetch<BM, BN>(ring, w, K, M, (c + 1) * BN);
    residual_store<BM, BN>(acc, xr, bias, out, row0, rows, M, c * BN);
  }
}

template <int BM, int BN>
int launch_mma(const void* attn, const void* w, const void* bias, const void* x_res, void* out,
               int B, int H, int Tlen, int Dh, int M, int tiles, cudaStream_t stream) {
  const size_t smem = mma_rows::smem_bytes(BM, BN, H * Dh, false);
  cudaError_t e = cudaFuncSetAttribute(attn_out_proj_mma_kernel<BM, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = B * Tlen, col_tiles = (M + BN - 1) / BN;
  dim3 grid((col_tiles + tiles - 1) / tiles, (rows + BM - 1) / BM);
  attn_out_proj_mma_kernel<BM, BN><<<grid, mma_rows::Tile<BM, BN>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(attn), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(x_res), static_cast<bf16*>(out), rows, Tlen, H, Dh, M, tiles);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// attn: (B, H, T, Dh); w: (H, Dh, M); bias: (M,); x_res, out: (B, T, M).
// All share `dtype` and are contiguous.
UV_EXPORT int uv_attn_out_proj(const void* attn, const void* w, const void* bias,
                               const void* x_res, void* out, int B, int H, int Tlen, int Dh,
                               int M, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Tlen <= 0 || Dh <= 0 || M <= 0 ||
      row_tile::smem_bytes(H * Dh) > row_tile::kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32) return launch<float>(attn, w, bias, x_res, out, B, H, Tlen, Dh, M, s);
  if (dtype == UV_BF16)
    return launch<__nv_bfloat16>(attn, w, bias, x_res, out, B, H, Tlen, Dh, M, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel, bf16 only, with the BM x 128 tile (BM 128, 64 or
// 32) and the column tiles a block runs (`tiles`) that the host's plan
// chose. Needs K = H * Dh with K % 16 == 0 and K <= 2048, Dh % 8 == 0,
// M % 8 == 0 and 16-byte-aligned attn, w, x_res and out; the bias may have
// any alignment.
UV_EXPORT int uv_attn_out_proj_mma(const void* attn, const void* w, const void* bias,
                                   const void* x_res, void* out, int B, int H, int Tlen, int Dh,
                                   int M, int bm, int tiles, void* stream) {
  constexpr int BN = 128;
  const int K = H * Dh;
  if (B <= 0 || H <= 0 || Tlen <= 0 || Dh <= 0 || M <= 0 || tiles <= 0 || K % 16 ||
      K > mma_rows::kMaxK || Dh % 8 || M % 8 ||
      mma_rows::smem_bytes(bm, BN, K, false) > mma_rows::kMaxSmem)
    return cudaErrorInvalidValue;
  if (!aligned16(attn) || !aligned16(w) || !aligned16(x_res) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128) return launch_mma<128, BN>(attn, w, bias, x_res, out, B, H, Tlen, Dh, M, tiles, s);
  if (bm == 64) return launch_mma<64, BN>(attn, w, bias, x_res, out, B, H, Tlen, Dh, M, tiles, s);
  if (bm == 32) return launch_mma<32, BN>(attn, w, bias, x_res, out, B, H, Tlen, Dh, M, tiles, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_attn_out_proj)
