// Attention of a few queries per row against a KV cache (and an optional
// carried tail), with an online softmax. Shared by decode_attention.cu,
// segment_attention.cu and paged_attention.cu, which each wrap `attend` in
// their own __global__ so each shows under its own name in a trace.
//
// The cache is either contiguous per row (key j of row b at b * c_b + j * c_s)
// or paged: with a page table, key j of row b sits in pool page
// min(table[b, j / page_size], num_pages - 1) at row j % page_size (page
// stride c_p). The table is read per key, not per tile, so any page size
// works, and sentinel (unallocated) ids clamp into the pool as the TPU
// kernels clamp them (ops/pallas/paged_attention.py:73-78).
//
// A block owns one (batch row, kv head) and up to max_cols<D>() "columns",
// one per (query t, query head g of the group): the G = H / Hkv query heads
// of a group share every K/V tile it stages in shared memory (GQA). Each
// segment is folded over exactly the keys some column can see, so a key
// past a row's length is never read, not even into shared memory.
//
// Arithmetic, as the TPU kernels (ops/pallas/decode_attention.py:_decode_kernel,
// ops/pallas/segment_attention.py:_seg_kernel): q is multiplied by the scale
// in q's dtype; logits are fp32 dot products; hidden keys get NEG_INF and
// probability 0; the softmax is online with natural exp; the probabilities
// stay fp32 into the PV product; the output is acc / max(z, 1e-30) in q's
// dtype.
#pragma once

#include <math.h>

#include "common.cuh"

namespace kvattn {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int BK = 32;     // keys per tile: one per lane
constexpr int kPairs = 8;  // (column, d) output pairs per thread
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // finite mask value

// columns a block can hold: 16 at D=64, 8 at D=128
template <int D>
__host__ __device__ constexpr int max_cols() { return kPairs * kThreads / D; }

struct Params {
  const void* q;  // (B, T, H, D) at strides q_b, q_t, q_h
  void* o;        // (B, T, H, D) at strides o_b, o_t, o_h
  const void* k;  // cache: (L, B, S, Hkv, D) at strides c_l, c_b, c_s, c_h
  const void* v;  //   (v shares k's strides)
  const void* tk; // tail (B, Ts, Hkv, D) at strides t_b, t_s, t_h, or null
  const void* tv;
  long long q_b, q_t, q_h, o_b, o_t, o_h;
  long long c_l, c_b, c_s, c_h, t_b, t_s, t_h;
  const int* lengths;  // (B,) valid cache entries
  const int* written;  // (B,) tail slots filled before these queries, or null
  // paged cache: (B, n_per) int32 page ids, or null for a contiguous cache;
  // then the cache strides are layer c_l, page c_p, row in page c_s, head c_h
  const int* table;
  long long c_p;
  int n_per, page_size, num_pages;
  int layer, window, T, G, S, Ts;
  // 1: the query sits at position n - 1 (lengths count it, decode);
  // 0: query t sits at n + written + t (segmented decode, after the prompt)
  int decode;
  float scale;  // already rounded to the input dtype
};

template <typename T, int D>
__device__ __forceinline__ void attend(const Params& p) {
  constexpr int CM = max_cols<D>();
  constexpr int CW = CM / kWarps;  // columns per warp
  __shared__ float Qs[CM * D];
  __shared__ float Ks[BK * (D + 1)];
  __shared__ float Vs[BK * D];
  __shared__ float Ps[CM * BK];  // this tile's probabilities
  __shared__ float Cs[CM];       // this tile's rescale of the accumulator
  __shared__ float Zs[CM];

  const int hk = blockIdx.x, b = blockIdx.y, c0 = blockIdx.z * CM;
  const int C = p.T * p.G;
  const int nc = min(CM, C - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = max(min(p.lengths[b], p.S), 0);
  const int wr = p.written ? p.written[b] : 0;
  const int qbase = p.decode ? n - 1 : n + wr;  // absolute position of query 0
  const int w = p.window;
  const int t_first = c0 / p.G, t_last = (c0 + nc - 1) / p.G;

  const T* q = static_cast<const T*>(p.q);
  for (int e = tid; e < nc * D; e += kThreads) {
    const int c = c0 + e / D, d = e % D;
    const int t = c / p.G, h = hk * p.G + c % p.G;
    Qs[e] = round_to<T>(to_f32(q[b * p.q_b + t * p.q_t + h * p.q_h + d]) * p.scale);
  }

  float m[CW], z[CW], acc[kPairs];
#pragma unroll
  for (int i = 0; i < CW; ++i) m[i] = kNegInf, z[i] = 0.f;
#pragma unroll
  for (int r = 0; r < kPairs; ++r) acc[r] = 0.f;

  // Fold keys [lo, hi) of one segment into the columns' running max, sum
  // and accumulator. row(j): element offset of key j from kb / vb;
  // visible(column, key).
  auto fold = [&](const T* kb, const T* vb, auto row, int lo, int hi, auto visible) {
    for (int k0 = lo; k0 < hi; k0 += BK) {
      const int len = min(BK, hi - k0);
      __syncthreads();  // the previous tile is consumed (and Qs is written)
      for (int e = tid; e < BK * D; e += kThreads) {
        const int j = e / D, d = e % D;
        const bool in = j < len;
        const long long off = in ? row(k0 + j) + d : 0;
        Ks[j * (D + 1) + d] = in ? to_f32(kb[off]) : 0.f;
        Vs[j * D + d] = in ? to_f32(vb[off]) : 0.f;
      }
      __syncthreads();
      // one warp per column: lane j scores key k0 + j
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int c = warp + kWarps * i;
        if (c < nc) {  // warp-uniform
          const bool ok = lane < len && visible(c0 + c, k0 + lane);
          float s = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) s = fmaf(Qs[c * D + d], Ks[lane * (D + 1) + d], s);
          s = ok ? s : kNegInf;
          const float m_new = fmaxf(m[i], warp_max(s));
          const float corr = expf(m[i] - m_new);
          const float e = ok ? expf(s - m_new) : 0.f;
          z[i] = z[i] * corr + warp_sum(e);
          m[i] = m_new;
          Ps[c * BK + lane] = e;
          if (lane == 0) Cs[c] = corr;
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPairs; ++r) {
        const int pair = tid + kThreads * r;
        if (pair < nc * D) {
          const int c = pair / D, d = pair % D;
          float a = acc[r] * Cs[c];
          for (int j = 0; j < len; ++j) a = fmaf(Ps[c * BK + j], Vs[j * D + d], a);
          acc[r] = a;
        }
      }
    }
  };

  // the cache segment: key j is visible to query t iff j < n and, with a
  // window, qbase + t - j < w
  {
    const int lo = w > 0 ? max(qbase + t_first - w + 1, 0) : 0;
    auto visible = [&](int c, int j) { return w <= 0 || j >= qbase + c / p.G - w + 1; };
    if (p.table) {
      const long long base = p.layer * p.c_l + hk * p.c_h;
      const int* tb = p.table + static_cast<long long>(b) * p.n_per;
      fold(static_cast<const T*>(p.k) + base, static_cast<const T*>(p.v) + base,
           [&](int j) {
             const int page = min(max(tb[j / p.page_size], 0), p.num_pages - 1);
             return page * p.c_p + (j % p.page_size) * p.c_s;
           },
           lo, n, visible);
    } else {
      const long long base = p.layer * p.c_l + b * p.c_b + hk * p.c_h;
      fold(static_cast<const T*>(p.k) + base, static_cast<const T*>(p.v) + base,
           [&](int j) { return j * p.c_s; }, lo, n, visible);
    }
  }
  // the tail: slot s (absolute position n + s) is visible to query t iff
  // s <= written + t and, with a window, written + t - s < w
  if (p.tk) {
    const long long base = b * p.t_b + hk * p.t_h;
    const int lo = w > 0 ? max(wr + t_first - w + 1, 0) : 0;
    const int hi = min(p.Ts, wr + t_last + 1);
    fold(static_cast<const T*>(p.tk) + base, static_cast<const T*>(p.tv) + base,
         [&](int s) { return s * p.t_s; }, lo, hi,
         [&](int c, int s) {
           const int t = c / p.G;
           return s <= wr + t && (w <= 0 || wr + t - s < w);
         });
  }

#pragma unroll
  for (int i = 0; i < CW; ++i) {
    const int c = warp + kWarps * i;
    if (c < nc && lane == 0) Zs[c] = z[i];
  }
  __syncthreads();
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int pair = tid + kThreads * r;
    if (pair < nc * D) {
      const int c = c0 + pair / D, d = pair % D;
      const int t = c / p.G, h = hk * p.G + c % p.G;
      o[b * p.o_b + t * p.o_t + h * p.o_h + d] = from_f32<T>(acc[r] / fmaxf(Zs[c - c0], 1e-30f));
    }
  }
}

// Launch the (T, D) instance `kernel` of attend over (Hkv, B, column chunks).
template <int D>
inline int launch(void (*kernel)(Params), const Params& p, int B, int Hkv, cudaStream_t s) {
  const int C = p.T * p.G;
  dim3 grid(Hkv, B, (C + max_cols<D>() - 1) / max_cols<D>());
  kernel<<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

}  // namespace kvattn

// Instantiate a __global__ wrapper of attend named NAME, and
// NAME_dispatch(dtype, D, ...) that launches its (dtype, head dim) instance.
#define UV_KV_ATTENTION_KERNEL(NAME)                                                   \
  template <typename T, int D>                                                         \
  __global__ void __launch_bounds__(kvattn::kThreads) NAME(const kvattn::Params p) {   \
    kvattn::attend<T, D>(p);                                                           \
  }                                                                                    \
  static int NAME##_dispatch(int dtype, int D, const kvattn::Params& p, int B, int Hkv, \
                             cudaStream_t s) {                                         \
    if (dtype == UV_F32 && D == 64) return kvattn::launch<64>(NAME<float, 64>, p, B, Hkv, s);  \
    if (dtype == UV_F32 && D == 128) return kvattn::launch<128>(NAME<float, 128>, p, B, Hkv, s); \
    if (dtype == UV_BF16 && D == 64)                                                   \
      return kvattn::launch<64>(NAME<__nv_bfloat16, 64>, p, B, Hkv, s);                \
    if (dtype == UV_BF16 && D == 128)                                                  \
      return kvattn::launch<128>(NAME<__nv_bfloat16, 128>, p, B, Hkv, s);              \
    return cudaErrorInvalidValue;                                                      \
  }
