// Shared helpers for the port's hand-written Hopper kernels.
//
// Every library exposes a plain C interface (bound from Python with ctypes):
// pointers and the CUDA stream arrive as void*, and each entry point returns
// the cudaError_t of its launch (0 on success) so the wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define UV_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
enum { UV_F32 = 0, UV_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round-to-nearest-even, as XLA's and PyTorch's casts do
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// value rounded through T and read back as fp32 (an "astype(T)" in fp32 math)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// exp2 of x rounded to bf16 as JAX computes it for a bf16 argument (its
// exp2 lowers to exp(x * ln 2) in the argument's dtype): ln 2, x, their
// product and the exponential each rounded to bf16
__device__ __forceinline__ float exp2_bf16(float x) {
  constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
  return round_to<__nv_bfloat16>(
      expf(round_to<__nv_bfloat16>(kLn2Bf16 * round_to<__nv_bfloat16>(x))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; `red` is __shared__ float[32]. All threads get it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nw) ? red[threadIdx.x] : 0.f;
  if (wid == 0) v = warp_sum(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// Each library exports <prefix>_error_string so the wrapper can name a failure.
#define UV_DEFINE_ERROR_STRING(prefix)                                  \
  UV_EXPORT const char* prefix##_error_string(int code) {               \
    return cudaGetErrorString(static_cast<cudaError_t>(code));          \
  }
