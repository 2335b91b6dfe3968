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
// flop/byte, under the bf16 ridge of ~295; on this version's CUDA-core
// FMAs the product, not the bytes, is what it waits on). Design:
// row_tile.cuh's tile. A block gathers its 32 (b, t) rows of every head
// into shared memory as the (32, H * Dh) left operand (each head's Dh
// values are one contiguous run of the native layout) and streams W
// through it; the epilogue reads the residual and writes the output once,
// so neither the concatenated heads nor the projection reach HBM.
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

UV_DEFINE_ERROR_STRING(uv_attn_out_proj)
