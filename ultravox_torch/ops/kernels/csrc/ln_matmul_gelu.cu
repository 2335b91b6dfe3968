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
// traffic, ~800 flop/byte. Design: ln_qkv_head.cu's tile (row_tile.cuh) with
// a GELU epilogue and a token-major store: the LN output and the pre-GELU
// activation never reach HBM. CUDA-core FMAs, not yet the tensor cores.
#include <math.h>

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

UV_DEFINE_ERROR_STRING(uv_ln_matmul_gelu)
