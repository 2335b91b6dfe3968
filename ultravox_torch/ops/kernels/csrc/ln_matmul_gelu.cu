// LayerNorm -> x fc1 + bias -> tanh-GELU, in one kernel:
// (B, T, D) x (D, F) + bias -> (B, T, F).
//
// Replaces ultravox_tpu/ops/pallas/fused_attention.py:ln_matmul_gelu (the
// encoder FFN's front half, which the reference keeps unwired; so does the
// port). Rounding points follow it: LN statistics and affine in fp32, the
// LN output cast to the input dtype; fp32-accumulated product cast to that
// dtype; + bias in that dtype; then upcast to fp32 for
// 0.5 y (1 + tanh(0.7978845608028654 (y + 0.044715 y^3))) and cast. Any T
// (the reference's T % 128 is a TPU layout rule).
//
// Bound on the card: operations. At the flagship encoder's fc1,
// (4, 500, 768) x (768, 3072), the product is 9.4 GFLOP against ~12 MB of
// traffic, ~800 flop/byte. Two kernels, chosen on the host before the
// launch (ops/kernels/fused_attention.py:_gelu_plan):
//
// ln_matmul_gelu_mma_kernel<BM, 128> (bf16; D % 16 == 0, D <= 2048,
// F % 8 == 0, 16-byte-aligned x, weight and LN vectors): ln_qkv_head.cu's
// tensor-core tile (csrc/mma_rows.cuh) with a GELU epilogue. A block
// LayerNorms its BM rows of x once into shared memory and keeps them there
// while it runs `tiles` 128-column tiles in turn, each through the 3-stage
// cp.async weight ring into mma.sync with fp32 sums; the next tile's first
// weight stages are in flight while this tile's epilogue runs. The
// epilogue works from the accumulators, so the resident rows and the ring
// are never overwritten: the sum rounded to bf16, the bias added in bf16,
// the GELU in fp32 (as y / (1 + e^(-2u)), see gelu_of_sum), rounded to
// bf16; the four lanes that share a row's 8 columns swap their halves with
// shuffles so that each stores one 16-byte line, token-major. A plain launch, no split K and no atomics:
// repeats are bit-equal.
//
// ln_matmul_gelu_kernel<T> (fp32, and every other shape or alignment): the
// CUDA-core 32 x 128 row tile of row_tile.cuh with fp32 FMAs, as the port
// first wrote it; its results are unchanged.
#include <math.h>

#include "mma_rows.cuh"
#include "row_tile.cuh"

namespace {

using namespace row_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_matmul_gelu_kernel(const T* __restrict__ x, const float* __restrict__ lns,
                      const float* __restrict__ lnb, const T* __restrict__ w,
                      const T* __restrict__ bias, T* __restrict__ out, int rows, int D,
                      int F, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;           // BM x D   normalised rows, rounded to T
  float* Ws = smem + BM * D;  // BK x BN  weight tile
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;

  layer_norm_rows(Hs, x, lns, lnb, row0, rows, D, eps);
  __syncthreads();
  float acc[4][4];
  product(Hs, Ws, w, D, F, n0, acc);

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n >= F) continue;
      const float y = round_to<T>(round_to<T>(acc[r][c]) + to_f32(bias[n]));
      const float g =
          0.5f * y * (1.f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
      out[static_cast<size_t>(row) * F + n] = from_f32<T>(g);
    }
  }
}

template <typename T>
int launch(const void* x, const void* lns, const void* lnb, const void* w, const void* bias,
           void* out, int rows, int D, int F, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(ln_matmul_gelu_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((F + BN - 1) / BN, (rows + BM - 1) / BM);
  ln_matmul_gelu_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const T*>(w), static_cast<const T*>(bias), static_cast<T*>(out), rows, D, F,
      eps);
  return cudaGetLastError();
}

using mma_tile::bf16;

// tanh-GELU of an fp32 sum, with ln_matmul_gelu_kernel<bf16>'s rounding
// points: the sum rounded to bf16, + bias in bf16, the GELU in fp32. The
// GELU is taken as 0.5 y (1 + tanh u) = y / (1 + e^(-2u)) with the card's
// fast exponential and division: on the H100 that made the kernel 8% (B 4)
// to 13% (B 1) faster than tanhf, with as many outputs off the plain
// version by a bf16 rounding (tanh.approx.f32 tripled them).
__device__ __forceinline__ float gelu_of_sum(float acc, float bias) {
  const float y = round_to<bf16>(round_to<bf16>(acc) + bias);
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return __fdividef(y, 1.f + __expf(-2.f * u));
}

// One output tile from the accumulators: GELU, then 16-byte lines to
// out[row, n0 + ...] (mma_rows::store_lines).
template <int BM, int BN>
__device__ __forceinline__ void gelu_store(const float (&acc)[2][mma_rows::Tile<BM, BN>::kNT][4],
                                           const bf16* __restrict__ bias, bf16* __restrict__ out,
                                           int row0, int rows, int F, int n0) {
  constexpr int NT = mma_rows::Tile<BM, BN>::kNT;
  float b[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + mma_rows::acc_col<BM, BN>(nt, 0);  // F % 8 == 0: n + 1 < F too
    b[nt][0] = n < F ? __bfloat162float(bias[n]) : 0.f;
    b[nt][1] = n < F ? __bfloat162float(bias[n + 1]) : 0.f;
  }
  mma_rows::store_lines<BM, BN>(
      acc, [&](float a, int nt, int j) { return gelu_of_sum(a, b[nt][j]); },
      [&](int, int, int r, int c, uint4 line) {
        const int row = row0 + r, n = n0 + c;
        if (row < rows && n < F)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * F + n) = line;
      });
}

template <int BM, int BN>
__global__ void __launch_bounds__(mma_rows::Tile<BM, BN>::kThreads)
ln_matmul_gelu_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                          const float* __restrict__ lnb, const bf16* __restrict__ w,
                          const bf16* __restrict__ bias, bf16* __restrict__ out, int rows, int D,
                          int F, int tiles, float eps) {
  using TL = mma_rows::Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw);  // LN scale, then bias
  bf16* A = reinterpret_cast<bf16*>(sb + 2 * D);  // BM x (D + 8): the rows, LayerNorm'd
  bf16* ring = A + BM * (D + 8);
  const int row0 = blockIdx.y * BM;
  const int c0 = blockIdx.x * tiles, c1 = min(c0 + tiles, (F + BN - 1) / BN);

  mma_rows::prefetch<BM, BN>(ring, w, D, F, c0 * BN);
  mma_rows::layer_norm_rows<BM, TL::kThreads>(A, sb, x, row0, rows, D, lns, lnb, eps);
  for (int c = c0; c < c1; ++c) {
    float acc[2][TL::kNT][4];
    mma_rows::product<BM, BN>(acc, A, D, ring, w, F, c * BN);  // ends with the ring free
    if (c + 1 < c1) mma_rows::prefetch<BM, BN>(ring, w, D, F, (c + 1) * BN);
    gelu_store<BM, BN>(acc, bias, out, row0, rows, F, c * BN);
  }
}

template <int BM, int BN>
int launch_mma(const void* x, const void* lns, const void* lnb, const void* w, const void* bias,
               void* out, int rows, int D, int F, int tiles, float eps, cudaStream_t stream) {
  const size_t smem = mma_rows::smem_bytes(BM, BN, D);
  cudaError_t e = cudaFuncSetAttribute(ln_matmul_gelu_mma_kernel<BM, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int col_tiles = (F + BN - 1) / BN;
  dim3 grid((col_tiles + tiles - 1) / tiles, (rows + BM - 1) / BM);
  ln_matmul_gelu_mma_kernel<BM, BN><<<grid, mma_rows::Tile<BM, BN>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias), static_cast<bf16*>(out), rows,
      D, F, tiles, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (rows, D); ln_scale, ln_bias: (D,) fp32; w: (D, F); bias: (F,);
// out: (rows, F). x, w, bias and out share `dtype`; all contiguous.
UV_EXPORT int uv_ln_matmul_gelu(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w, const void* bias, void* out, int rows, int D,
                                int F, float eps, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || F <= 0 || row_tile::smem_bytes(D) > row_tile::kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32)
    return launch<float>(x, ln_scale, ln_bias, w, bias, out, rows, D, F, eps, s);
  if (dtype == UV_BF16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w, bias, out, rows, D, F, eps, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel, bf16 only, with the BM x 128 tile (BM 128, 64 or
// 32) and the column tiles a block runs (`tiles`) that the host's plan
// chose. Needs D % 16 == 0, D <= 2048, F % 8 == 0 and 16-byte-aligned x,
// ln_scale, ln_bias, w and out; the bias may have any alignment.
UV_EXPORT int uv_ln_matmul_gelu_mma(const void* x, const void* ln_scale, const void* ln_bias,
                                    const void* w, const void* bias, void* out, int rows, int D,
                                    int F, float eps, int bm, int tiles, void* stream) {
  constexpr int BN = 128;
  if (rows <= 0 || D <= 0 || F <= 0 || tiles <= 0 || D % 16 || D > mma_rows::kMaxK || F % 8 ||
      mma_rows::smem_bytes(bm, BN, D) > mma_rows::kMaxSmem)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(ln_scale) || !aligned16(ln_bias) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch_mma<128, BN>(x, ln_scale, ln_bias, w, bias, out, rows, D, F, tiles, eps, s);
  if (bm == 64)
    return launch_mma<64, BN>(x, ln_scale, ln_bias, w, bias, out, rows, D, F, tiles, eps, s);
  if (bm == 32)
    return launch_mma<32, BN>(x, ln_scale, ln_bias, w, bias, out, rows, D, F, tiles, eps, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_ln_matmul_gelu)
