// Skinny matrix product for decode: x (M <= 32, K) times w (K, N) -> (M, N).
//
// Replaces ultravox_tpu/ops/pallas/decode_matmul.py:decode_matmul (unwired
// in the reference; the port keeps lora.py's w8a16 product as it is).
// Numerics follow it: x is bf16 or fp32, w bf16 or int8 and cast to x's
// dtype (exact in every supported pair, as is each product in fp32), sums
// in fp32, an optional per-output-channel scale (fp32 or bf16) multiplies
// the fp32 sum, then the cast to the output dtype. N and K need not be
// multiples of 128.
//
// Bound on the card: bytes. At M = 4 a weight byte meets 4-8 FMAs, far
// under the ~295 flop/byte ridge, so the time is one read of w. Design:
// each lane of a warp owns CPT neighbouring columns and loads them as one
// vector of up to 16 bytes, so a warp reads one contiguous span of a weight
// row. Each of the block's 8 warps takes one contiguous run of the block's
// K rows and walks it with no barrier: the next group's loads (64 bytes a
// lane: 4 rows of 16-byte vectors, 8 of narrower ones) are issued before
// the current group's FMAs, so loads stay in flight. x (a few KB) is
// read as a warp-wide broadcast that L1 serves. Weights become fp32 with
// integer ops (bf16: a shift; int8: the byte placed under the exponent of
// 2^23, then 2^23 + 128 subtracted), not the conversion unit. Each lane
// holds MT x CPT fp32 sums (at most 32: CPT shrinks as M grows); the 8
// warps' sums are added in shared memory in a fixed order. Where N gives
// too few column tiles to fill the card, K is split over blocks
// (gridDim.y) that write fp32 partial sums, and a second kernel adds them
// in split order and applies the scale and the cast; the result does not
// depend on timing.
#include "common.cuh"

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxAcc = 32;

enum { W_BF16 = 1, W_INT8 = 2, SCALE_NONE = -1 };

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// 32-bit word i of a raw vector
__device__ __forceinline__ unsigned int word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}
__device__ __forceinline__ unsigned int word(const uint2& r, int i) { return i == 0 ? r.x : r.y; }
__device__ __forceinline__ unsigned int word(unsigned int r, int) { return r; }
__device__ __forceinline__ unsigned int word(unsigned short r, int) { return r; }
__device__ __forceinline__ unsigned int word(unsigned char r, int) { return r; }

// element c of a raw vector of W, as fp32 (exact)
template <typename W, typename R>
__device__ __forceinline__ float w_at(const R& r, int c) {
  if constexpr (sizeof(W) == 2) {  // bf16: the bits are the top half of an fp32
    const unsigned int v = word(r, c / 2);
    return __uint_as_float(c % 2 ? v & 0xffff0000u : v << 16);
  } else {  // int8 b: 0x4b0000uu is 2^23 + uu as fp32, uu = b + 128
    const unsigned int v = __byte_perm(word(r, c / 4) ^ 0x80808080u, 0x4b000000u, 0x7440 | (c % 4));
    return __uint_as_float(v) - 8388736.f;
  }
}

template <typename W, typename Vec, int U>
__device__ __forceinline__ void load_rows(Vec (&v)[U], const W* __restrict__ wp, int k, int r1,
                                          int N) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    v[u] = k + u < r1 ? __ldg(reinterpret_cast<const Vec*>(wp + static_cast<size_t>(k + u) * N))
                      : Vec{};
}

// acc[m][c] += sum over rows [r0, r1) of x[m, k] * w[k, c] for this lane's
// columns (wp points at its first); rows of x past M read as 0
template <typename X, typename W, int MT, int CPT>
__device__ __forceinline__ void accumulate(const X* __restrict__ x, long long x_stride,
                                           const W* __restrict__ wp, int M, int N, int r0,
                                           int r1, float (&acc)[MT][CPT]) {
  using Vec = typename Raw<CPT * sizeof(W)>::type;
  constexpr int U = sizeof(Vec) >= 16 ? 4 : 8;  // rows per group
  Vec cur[U];
  load_rows<W>(cur, wp, r0, r1, N);
  for (int k = r0; k < r1; k += U) {
    Vec nxt[U];
    load_rows<W>(nxt, wp, k + U, r1, N);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kr = min(k + u, r1 - 1);  // rows past r1 carry 0 weights
      float a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = m < M ? to_f32(x[m * x_stride + kr]) : 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float wv = w_at<W>(cur[u], c);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(a[m], wv, acc[m][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
}

__device__ __forceinline__ float load_any(const void* p, int code, size_t i) {
  return code == UV_F32 ? static_cast<const float*>(p)[i]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_any(void* p, int code, size_t i, float v) {
  if (code == UV_F32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// the epilogue: sum * scale (if any), cast to the output dtype
__device__ __forceinline__ void finish(float acc, const void* scale, int scale_code, void* out,
                                       int out_code, int m, int n, int N) {
  if (scale_code != SCALE_NONE) acc *= load_any(scale, scale_code, n);
  store_any(out, out_code, static_cast<size_t>(m) * N + n, acc);
}

template <typename W, int MT, int CPT>
__global__ void __launch_bounds__(kThreads, 2)
decode_matmul_kernel(const void* __restrict__ x, long long x_stride, int x_code,
                     const W* __restrict__ w, const void* __restrict__ scale, int scale_code,
                     void* __restrict__ out, int out_code, float* __restrict__ partial, int M,
                     int K, int N, int k_split) {
  static_assert(MT * CPT <= kMaxAcc, "too many sums per lane");
  __shared__ __align__(16) float smem[(kWarps / 2) * 32 * MT * CPT];  // the warps' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (blockIdx.x * 32 + lane) * CPT;
  const bool live = col < N;  // N % CPT == 0: a lane's columns are all in or all out
  const int k_begin = blockIdx.y * k_split, k_end = min(K, k_begin + k_split);
  const int per_warp = (k_end - k_begin + kWarps - 1) / kWarps;
  const int r0 = k_begin + warp * per_warp, r1 = min(k_end, r0 + per_warp);

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;
  if (live) {
    if (x_code == UV_F32)
      accumulate(static_cast<const float*>(x), x_stride, w + col, M, N, r0, r1, acc);
    else
      accumulate(static_cast<const __nv_bfloat16*>(x), x_stride, w + col, M, N, r0, r1, acc);
  }

  // the 8 warps' sums, added pairwise in a fixed order: 4-7 onto 0-3, 2-3
  // onto 0-1, 1 onto 0
  for (int half = kWarps / 2; half > 0; half /= 2) {
    __syncthreads();
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          smem[(((warp - half) * MT + m) * CPT + c) * 32 + lane] = acc[m][c];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[m][c] += smem[((warp * MT + m) * CPT + c) * 32 + lane];
    }
  }
  if (warp != 0 || !live) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (gridDim.y == 1)
        finish(acc[m][c], scale, scale_code, out, out_code, m, col + c, N);
      else
        partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + col + c] = acc[m][c];
    }
  }
}

// partial: (splits, M, N) fp32 -> out (M, N), the splits added in order
__global__ void __launch_bounds__(kThreads)
decode_matmul_reduce_kernel(const float* __restrict__ partial, int splits, int M, int N,
                            const void* __restrict__ scale, int scale_code,
                            void* __restrict__ out, int out_code) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t MN = static_cast<size_t>(M) * N;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[s * MN + i];
  finish(acc, scale, scale_code, out, out_code, static_cast<int>(i / N), static_cast<int>(i % N),
         N);
}

template <typename W, int MT, int CPT>
int launch(const void* x, long long x_stride, int x_code, const void* w, const void* scale,
           int scale_code, void* out, int out_code, void* partial, int M, int K, int N,
           int splits, int k_split, cudaStream_t stream) {
  dim3 grid((N + 32 * CPT - 1) / (32 * CPT), splits);
  decode_matmul_kernel<W, MT, CPT><<<grid, kThreads, 0, stream>>>(
      x, x_stride, x_code, static_cast<const W*>(w), scale, scale_code, out, out_code,
      static_cast<float*>(partial), M, K, N, k_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t MN = static_cast<size_t>(M) * N;
  decode_matmul_reduce_kernel<<<static_cast<unsigned>((MN + kThreads - 1) / kThreads), kThreads,
                                0, stream>>>(static_cast<const float*>(partial), splits, M, N,
                                             scale, scale_code, out, out_code);
  return cudaGetLastError();
}

// CPT: the vector width the wrapper planned (MT * CPT <= 64, at most 16
// bytes), or 1 where N or the weight's address does not allow a vector
template <typename W, int MT>
int dispatch_cpt(int cpt, const void* x, long long xs, int xc, const void* w, const void* sc,
                 int scc, void* out, int oc, void* part, int M, int K, int N, int splits,
                 int k_split, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(W) < kMaxAcc / MT ? 16 / sizeof(W) : kMaxAcc / MT;
  if (cpt == kVec)
    return launch<W, MT, kVec>(x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
  if (cpt == 1)
    return launch<W, MT, 1>(x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
  return cudaErrorInvalidValue;
}

template <typename W>
int dispatch_mt(int mt, int cpt, const void* x, long long xs, int xc, const void* w,
                const void* sc, int scc, void* out, int oc, void* part, int M, int K, int N,
                int splits, int k_split, cudaStream_t s) {
  switch (mt) {
    case 1: return dispatch_cpt<W, 1>(cpt, x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
    case 4: return dispatch_cpt<W, 4>(cpt, x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
    case 8: return dispatch_cpt<W, 8>(cpt, x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
    case 16: return dispatch_cpt<W, 16>(cpt, x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
    case 32: return dispatch_cpt<W, 32>(cpt, x, xs, xc, w, sc, scc, out, oc, part, M, K, N, splits, k_split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) fp32 or bf16 (x_code), rows x_stride elements apart; w: (K, N)
// bf16 or int8 (w_code), contiguous; scale: (N,) fp32 or bf16, or null
// (scale_code -1); out: (M, N) contiguous, fp32 or bf16 (out_code);
// partial: (splits, M, N) fp32 scratch when splits > 1. mt: the sums'
// row count (1, 4, 8, 16 or 32, at least M); cpt: columns per lane;
// blockIdx.y takes K rows [y * k_split, (y + 1) * k_split).
UV_EXPORT int uv_decode_matmul(const void* x, long long x_stride, int x_code, const void* w,
                               int w_code, const void* scale, int scale_code, void* out,
                               int out_code, void* partial, int M, int K, int N, int mt, int cpt,
                               int splits, int k_split, void* stream) {
  if (M <= 0 || M > mt || K <= 0 || N <= 0 || N % cpt || splits <= 0 || splits > 65535 ||
      k_split <= 0 || static_cast<long long>(splits) * k_split < K ||
      static_cast<long long>(splits - 1) * k_split >= K || (splits > 1 && !partial))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_code == W_BF16)
    return dispatch_mt<__nv_bfloat16>(mt, cpt, x, x_stride, x_code, w, scale, scale_code, out,
                                      out_code, partial, M, K, N, splits, k_split, s);
  if (w_code == W_INT8)
    return dispatch_mt<int8_t>(mt, cpt, x, x_stride, x_code, w, scale, scale_code, out,
                               out_code, partial, M, K, N, splits, k_split, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_decode_matmul)
