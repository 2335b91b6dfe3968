// LayerNorm over the last axis: fp32 statistics and affine, cast back.
//
// Replaces ultravox_tpu/ops/pallas/layer_norm.py:fused_layer_norm.
// Bound on the card: bytes. It reads each row once and writes it once
// (2*rows*D*sizeof(T)), with ~8 flops per element, far below Hopper's
// ~295 flop/byte ridge. Design: one block per row; the row is read from HBM
// once into shared memory as fp32, the mean and the centred variance are two
// block reductions over that copy, and the normalised row is written once,
// so HBM traffic is exactly one read and one write.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int D,
                  float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = to_f32(x[base + i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float c = row[i] - mean;
    ss += c * c;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float y = (row[i] - mean) * rstd;
    out[base + i] = from_f32<T>(y * scale[i] + bias[i]);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out,
           long long rows, int D, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        layer_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  layer_norm_kernel<T><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, D) of `dtype`; scale, bias: (D,) fp32.
UV_EXPORT int uv_layer_norm(const void* x, const void* scale, const void* bias,
                            void* out, long long rows, int D, float eps,
                            int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || D > 56 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32) return launch<float>(x, scale, bias, out, rows, D, eps, s);
  if (dtype == UV_BF16) return launch<__nv_bfloat16>(x, scale, bias, out, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_layer_norm)
