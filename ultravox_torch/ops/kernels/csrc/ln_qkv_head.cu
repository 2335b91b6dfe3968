// LayerNorm -> qkv projection -> head-major relayout, in one kernel:
// (B, T, D) x (D, C) + bias -> (B, G, T, Dh), G = C / Dh = 3 * num_heads.
//
// Replaces ultravox_tpu/ops/pallas/fused_attention.py:ln_qkv_head_fused.
// Numerics follow it: LN statistics and affine in fp32, the LN output cast
// to the input dtype before the product, fp32 accumulation, the accumulator
// cast to the output dtype, and only then the bias added (in that dtype).
//
// Bound on the card: operations. At the whisper-small encoder shape
// (B*T = 2048 rows, D = 768, C = 2304) the product is 7.2 GFLOP against
// ~9 MB of traffic, ~800 flop/byte, above the H100's ~295 ridge. Design:
// a block owns a 32-row x 128-column output tile (row_tile.cuh). It
// normalises its 32 rows once into shared memory (so the LN output never
// reaches HBM), then streams 32 x 128 weight tiles through shared memory
// and accumulates a 4 x 4 register tile per thread with fp32 FMAs; the
// epilogue writes each element straight to its head-major slot, so the
// (B, T, C) intermediate and the relayout pass of the unfused form never
// exist. This first version uses CUDA-core FMAs, not the tensor cores: it
// is far from the bf16 bound, and wgmma/TMA tiling is the known next step.
#include "row_tile.cuh"

namespace {

using namespace row_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_head_kernel(const T* __restrict__ x, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out, int rows,
                   int Tlen, int D, int C, int Dh, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;           // BM x D   normalised rows, rounded to T
  float* Ws = smem + BM * D;  // BK x BN  weight tile
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int G = C / Dh;

  layer_norm_rows(Hs, x, lns, lnb, row0, rows, D, eps);
  __syncthreads();
  float acc[4][4];
  product(Hs, Ws, w, D, C, n0, acc);

  // cast, bias in the output dtype, head-major store
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= rows) continue;
    const int b = row / Tlen, t = row % Tlen;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n >= C) continue;
      const float y = round_to<T>(acc[r][c]) + to_f32(bias[n]);
      const int g = n / Dh, d = n % Dh;
      out[((static_cast<size_t>(b) * G + g) * Tlen + t) * Dh + d] = from_f32<T>(y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* lns, const void* lnb, const void* w,
           const void* bias, void* out, int B, int Tlen, int D, int C, int Dh,
           float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      ln_qkv_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = B * Tlen;
  dim3 grid((C + BN - 1) / BN, (rows + BM - 1) / BM);
  ln_qkv_head_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, Tlen, D, C, Dh, eps);
  return cudaGetLastError();
}

}  // namespace

// x: (B, T, D); ln_scale, ln_bias: (D,) fp32; w: (D, C); bias: (C,);
// out: (B, C / Dh, T, Dh). x, w, bias and out share `dtype`.
UV_EXPORT int uv_ln_qkv_head(const void* x, const void* ln_scale,
                             const void* ln_bias, const void* w,
                             const void* bias, void* out, int B, int Tlen,
                             int D, int C, int Dh, float eps, int dtype,
                             void* stream) {
  // the row tile must fit the shared memory a block may use
  if (B <= 0 || Tlen <= 0 || D <= 0 || Dh <= 0 || C % Dh ||
      row_tile::smem_bytes(D) > row_tile::kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32)
    return launch<float>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  if (dtype == UV_BF16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_ln_qkv_head)
