// LayerNorm over the last axis: fp32 statistics and affine, cast back.
//
// Replaces ultravox_tpu/ops/pallas/layer_norm.py:fused_layer_norm.
// Bound on the card: bytes. It reads each row once and writes it once
// (2*rows*D*sizeof(T)), with ~8 flops per element, far below Hopper's
// ~295 flop/byte ridge. At the encoder's (4, 500, 768) that is 6.1 MB,
// which L2 holds, so what sets the time is the launch and each row's chain
// of dependent steps, not HBM. Design:
//
//   1. One warp per row, 8 rows a 256-thread block: (4, 500, 768) is 250
//      blocks, one wave. Each lane loads its NV pieces of the row as 16-byte
//      vectors, all issued before the first is used, and holds them in
//      registers as fp32 (768 bf16 columns: 3 vectors, 24 values a lane).
//   2. The mean and then the centred variance (the reference's two passes,
//      not E[x^2] - mean^2, which cancels) are warp shuffles over those
//      registers: no shared memory and no barrier.
//   3. Scale and bias are read as fp32 vectors, the output written as
//      16-byte vectors.
//   4. A ragged D or a pointer off 16 bytes takes the same kernel with one
//      element a piece (V = 1). A D past the register budget (4096) keeps a
//      block per row: the row read once into shared memory as fp32, two
//      block reductions.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kRowsPerBlock = kThreads / 32;

// V elements of T at p, as fp32
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 2) {
    uint4 u;
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

// fp32 scale or bias at p, V values
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      f[i] = u.x, f[i + 1] = u.y, f[i + 2] = u.z, f[i + 3] = u.w;
    }
  }
}

// one warp per row; piece i of lane l is columns [(i * 32 + l) V, + V)
template <typename T, int V, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out, long long rows,
                       int D, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * D;
  float v[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c < D) {
      load_vec<T, V>(xr + c, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) s += v[i][j];
  const float mean = warp_sum(s) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if ((i * 32 + lane) * V < D) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = v[i][j] - mean;
        ss += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);
  T* o = out + row * D;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * V;
    if (c >= D) continue;
    float sc[V], bi[V], y[V];
    load_f32<V>(scale + c, sc);
    load_f32<V>(bias + c, bi);
#pragma unroll
    for (int j = 0; j < V; ++j) y[j] = (v[i][j] - mean) * rstd * sc[j] + bi[j];
    store_vec<T, V>(o + c, y);
  }
}

// one block per row, for a D past the warp kernel's registers
template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int D, float eps) {
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
int launch_block(const void* x, const void* scale, const void* bias, void* out, long long rows,
                 int D, float eps, cudaStream_t stream) {
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

template <typename T, int V, int NV>
int launch_warp(const void* x, const void* scale, const void* bias, void* out, long long rows,
                int D, float eps, cudaStream_t stream) {
  if (static_cast<long long>(NV) * 32 * V < D) return cudaErrorInvalidValue;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_warp_kernel<T, V, NV><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, D, eps);
  return cudaGetLastError();
}

#define UV_LN_CASE(NV) \
  case NV: return launch_warp<T, V, NV>(x, scale, bias, out, rows, D, eps, s);

// the pieces a lane holds: the wrapper's layer_norm.WARP_PIECES
template <typename T, int V>
int dispatch_warp(int nv, const void* x, const void* scale, const void* bias, void* out,
                  long long rows, int D, float eps, cudaStream_t s) {
  if constexpr (V == 1) {
    switch (nv) {
      UV_LN_CASE(1) UV_LN_CASE(2) UV_LN_CASE(4) UV_LN_CASE(8) UV_LN_CASE(16) UV_LN_CASE(32)
      UV_LN_CASE(64) UV_LN_CASE(128)
    }
  } else {
    switch (nv) {
      UV_LN_CASE(1) UV_LN_CASE(2) UV_LN_CASE(3) UV_LN_CASE(4) UV_LN_CASE(6) UV_LN_CASE(8)
      UV_LN_CASE(12) UV_LN_CASE(16)
      default:
        if constexpr (sizeof(T) == 4) {
          switch (nv) { UV_LN_CASE(24) UV_LN_CASE(32) }
        }
    }
  }
  return cudaErrorInvalidValue;
}

#undef UV_LN_CASE

template <typename T>
int dispatch(int vec, int nv, const void* x, const void* scale, const void* bias, void* out,
             long long rows, int D, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  if (nv == 0) return launch_block<T>(x, scale, bias, out, rows, D, eps, s);
  if (vec) {
    if (D % kVec) return cudaErrorInvalidValue;
    return dispatch_warp<T, kVec>(nv, x, scale, bias, out, rows, D, eps, s);
  }
  return dispatch_warp<T, 1>(nv, x, scale, bias, out, rows, D, eps, s);
}

}  // namespace

// x, out: (rows, D) of `dtype`; scale, bias: (D,) fp32. nv: 16-byte pieces
// (vec) or elements (!vec) a lane holds in the warp-per-row kernel, whose
// 32 nv pieces must cover D; 0 takes the block-per-row kernel. vec needs D
// a multiple of a piece and x, out, scale and bias on 16 bytes.
UV_EXPORT int uv_layer_norm(const void* x, const void* scale, const void* bias,
                            void* out, long long rows, int D, float eps,
                            int dtype, int vec, int nv, void* stream) {
  if (rows <= 0 || D <= 0 || D > 56 * 1024 || nv < 0) return cudaErrorInvalidValue;
  if (vec && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
              reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias)) % 16)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32) return dispatch<float>(vec, nv, x, scale, bias, out, rows, D, eps, s);
  if (dtype == UV_BF16)
    return dispatch<__nv_bfloat16>(vec, nv, x, scale, bias, out, rows, D, eps, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_layer_norm)
