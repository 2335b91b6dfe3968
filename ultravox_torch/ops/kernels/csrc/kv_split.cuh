// Attention of a few queries per row against a KV cache (and an optional
// carried tail), with the keys of each row split across a thread block
// cluster. The kernel of all four KV attention functions, each wrapped in
// its own __global__ so a trace tells them apart:
//   decode_attention.cu                   #8  contiguous cache, one query
//   segment_attention.cu                  #11 contiguous cache + tail
//   paged_attention.cu                    #9  paged pool, one query
//   segment_attention.cu (second entry)   #12 paged pool + tail
//
// The cache is contiguous per row (key j of row b at b * c_b + j * c_s) or,
// with Paged, a pool of pages: key j of row b sits in page
// min(max(table[b, j / page_size], 0), num_pages - 1) at row j % page_size
// (page stride c_p, layer stride c_l), so a sentinel (unallocated) id reads
// finite pool data and never faults. Paged is a template parameter: the
// contiguous instances hold no page arithmetic.
//
// Bound on the card: bytes, and at decode sizes latency. A row reads its
// visible keys and values once (~1 flop per byte in bf16), a few hundred KB
// a call, so what sets the time is how many blocks run at once and how many
// dependent steps each one takes. Design, in that order:
//
//   1. Grid (NS * Hkv, B, column chunks) in clusters of NS blocks along x.
//      The NS ranks of a cluster share one (row, kv head, chunk of columns)
//      and split its visible keys: cache keys [lo, n), then tail slots
//      [lo_t, hi_t), seen as one virtual range of N keys, of which rank r
//      takes [r * share, (r + 1) * share), share = ceil(N / NS) rounded up
//      to kGranule keys. NS comes from the slab size on the host, never from
//      the lengths (reading them would make the host wait). A rank with no
//      keys keeps m = NEG_INF, z = 0, acc = 0.
//   2. The NS partial softmax states merge through distributed shared
//      memory: after cluster.sync() each rank owns a slice of the (column, d)
//      outputs and reads every rank's (m, z, acc) in rank order 0 .. NS-1:
//      m = max m_i, z = sum z_i exp(m_i - m), acc likewise, out = acc /
//      max(z, 1e-30). No workspace, no atomics, no second launch, and every
//      sum runs in a fixed order, so two runs are bit-equal.
//   3. Each lane loads 16 bytes of a key row and of its value row straight
//      into registers (a D = 64 bf16 row is 8 lanes, so one warp instruction
//      reads 4 keys); kUnroll key steps are in flight together. A key's row
//      offset is computed once, with no division per element.
//   4. Paged rows: each lane group's page-table entries for the NEXT step
//      load together with this step's K/V, so no K/V load waits on the
//      table, and the page of key j is j / page_size by a host-computed
//      multiply-high divisor (any page size, no integer division). The
//      lanes of a key share one entry (one load of the same address).
//   5. The LK lanes of a key each hold V of the D dims of every column's
//      scaled query, so every column of the chunk uses each K load;
//      log2(LK) shuffles finish each logit, and PV runs from the same
//      registers. The key groups of a warp share one running max (a few
//      shuffles a step), so their partial sums add up by shuffles at the
//      end without a rescale; warps merge in shared memory, then the
//      cluster as in 2. The kernel is bound by its chain of dependent
//      instructions, and this keeps that chain short.
//
// No tensor cores: at T = 1 and G = 4 a kv head has 4 query rows, so an
// mma m16 tile would waste three quarters of its rows, and the work is about
// 1 flop per byte. fp32 runs the same code (4 floats per 16-byte load).
//
// Arithmetic, as the TPU kernels (ops/pallas/decode_attention.py:
// _decode_kernel, ops/pallas/paged_attention.py:_paged_decode_kernel,
// ops/pallas/segment_attention.py:_seg_kernel and _paged_seg_kernel): q is
// multiplied by the scale in q's dtype; logits are
// fp32 dot products; hidden keys get NEG_INF and probability 0; the exp is
// natural; the probabilities stay fp32 into PV; the output is
// acc / max(z, 1e-30) in q's dtype. A key past a row's length is never read.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace kvsplit {

namespace cg = cooperative_groups;

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kUnroll = 2;     // key steps whose loads are in flight together
constexpr int kGranule = 16;   // a rank's share of keys is a multiple of this
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // finite mask value

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
  // paged cache: (B, n_per) int32 page ids; the cache strides are then
  // layer c_l, page c_p, row in page c_s, head c_h (c_b unused)
  const int* table;
  long long c_p;
  int n_per, page_size, num_pages;
  unsigned ps_magic;  // j / page_size = (umulhi(j, ps_magic) + j) >> ps_shift
  int ps_shift;
  int layer, window, T, G, S, Ts;
  // 1: the query sits at position n - 1 (lengths count it, decode);
  // 0: query t sits at n + written + t (segmented decode, after the prompt)
  int decode;
  float scale;  // already rounded to the input dtype
};

// page_size d and its multiply-high divisor, on the host: page_div(p, j) is
// j / d for every 0 <= j < 2^31, with s = ceil(log2 d) and
// magic = floor(2^32 (2^s - d) / d) + 1 (it fits in 32 bits).
inline void set_page_size(Params& p, int d) {
  int s = 0;
  while ((1u << s) < static_cast<unsigned>(d)) ++s;
  const unsigned long long one = 1;
  p.page_size = d;
  p.ps_shift = s;
  p.ps_magic = static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1);
}

__device__ __forceinline__ int page_div(const Params& p, int j) {
  const unsigned u = static_cast<unsigned>(j);
  return static_cast<int>((__umulhi(u, p.ps_magic) + u) >> p.ps_shift);
}

template <typename T, int D>
struct Shape {
  static constexpr int V = 16 / sizeof(T);  // elements of one 16-byte load
  static constexpr int LK = D / V;          // lanes that hold one key row
  static constexpr int KW = 32 / LK;        // keys a warp reads per step
  static constexpr int CM = 32 / V;         // columns a block holds: 4 bf16, 8 fp32
  static_assert(LK >= 1 && LK <= 32 && 32 % LK == 0, "a key row spans 1-32 lanes");
};

// 16 bytes widened to fp32 (exact for both types)
__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {  // 8 bf16
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4]) {  // 4 fp32
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}

template <typename T, int D, bool Paged>
__device__ __forceinline__ void attend(const Params& p) {
  using Sh = Shape<T, D>;
  constexpr int V = Sh::V, LK = Sh::LK, KW = Sh::KW, CM = Sh::CM;
  constexpr int STEP = kWarps * KW;  // keys of one block step
  __shared__ float Wm[kWarps][CM], Wz[kWarps][CM];  // each warp's partial
  __shared__ float Wacc[kWarps][CM * D];
  __shared__ float Bm[CM], Bz[CM];  // this block's partial, read by every rank
  __shared__ float Bacc[CM * D];
  __shared__ long long Ocol[CM];  // output offset of each column

  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hk = blockIdx.x / ns, b = blockIdx.y, c0 = blockIdx.z * CM;
  const int nc = min(CM, p.T * p.G - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LK, li = lane % LK;  // key of the warp step, dims [li V, li V + V)

  // this lane's dims of every column's query, times the scale in q's dtype
  const T* q = static_cast<const T*>(p.q);
  float qr[CM][V];
  int tc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    const bool live = c < nc;
    const int t = live ? (c0 + c) / p.G : 0, h = hk * p.G + (live ? (c0 + c) % p.G : 0);
    const T* qp = q + b * p.q_b + t * p.q_t + h * p.q_h + li * V;
#pragma unroll
    for (int e = 0; e < V; ++e) qr[c][e] = live ? round_to<T>(to_f32(qp[e]) * p.scale) : 0.f;
    tc[c] = t;
    if (tid == c) Ocol[c] = b * p.o_b + t * p.o_t + h * p.o_h;
  }

  const int n = max(min(p.lengths[b], p.S), 0);
  const int wr = p.written ? p.written[b] : 0;
  const int qbase = p.decode ? n - 1 : n + wr;  // absolute position of query 0
  const int w = p.window;
  const int t_first = c0 / p.G, t_last = (c0 + nc - 1) / p.G;
  // absolute key positions column c sees: [c_lo, c_hi]; cache key j sits at
  // j, tail slot s at n + s (decode: the query at n - 1 sees [n - w, n - 1])
  int c_lo[CM], c_hi[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    c_hi[c] = c < nc ? qbase + tc[c] : -1;
    c_lo[c] = w > 0 ? qbase + tc[c] - w + 1 : 0;
  }
  // the keys some column of the chunk sees: cache [lo, n), tail [lo_t, lo_t + nT)
  const int lo = w > 0 ? min(max(qbase + t_first - w + 1, 0), n) : 0;
  const int nC = n - lo;
  int lo_t = 0, nT = 0;
  if (p.tk) {
    lo_t = w > 0 ? max(wr + t_first - w + 1, 0) : 0;
    nT = max(min(p.Ts, wr + t_last + 1) - lo_t, 0);
  }
  const int N = nC + nT;
  const int share = ((N + ns - 1) / ns + kGranule - 1) / kGranule * kGranule;
  const int k_begin = min(rank * share, N), k_end = min(k_begin + share, N);

  const long long cbase =
      p.layer * p.c_l + (Paged ? 0 : b * p.c_b) + hk * p.c_h + li * V;  // paged: page 0
  const T* kc = static_cast<const T*>(p.k) + cbase;
  const T* vc = static_cast<const T*>(p.v) + cbase;
  const long long tbase = b * p.t_b + hk * p.t_h + li * V;
  const T* kt = p.tk ? static_cast<const T*>(p.tk) + tbase : kc;
  const T* vt = p.tv ? static_cast<const T*>(p.tv) + tbase : vc;

  float m[CM], z[CM], acc[CM][V];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    m[c] = kNegInf, z[c] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[c][e] = 0.f;
  }

  // paged: the table entry (pg) and row in page (pr) of the cache key that
  // lane group grp reads at key step u, one step ahead of the K/V loads
  const int* tb = Paged ? p.table + static_cast<long long>(b) * p.n_per : nullptr;
  const int c_end = min(nC, k_end);
  int pg[kUnroll], pr[kUnroll];
  auto lookup = [&](int k0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = k0 + u * STEP + grp;
      pg[u] = pr[u] = 0;
      if (i < c_end) {
        const int j = lo + i, t = page_div(p, j);
        pr[u] = j - t * p.page_size;
        pg[u] = __ldg(tb + t);
      }
    }
  };
  if constexpr (Paged) lookup(k_begin + warp * KW);

  // warp-uniform loop: lane group grp reads key k0 + u * STEP + grp
  for (int k0 = k_begin + warp * KW; k0 < k_end; k0 += kUnroll * STEP) {
    uint4 kr[kUnroll], vr[kUnroll];
    int pos[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = k0 + u * STEP + grp;  // virtual key index
      const bool cache = i < nC;
      const int j = cache ? lo + i : lo_t + (i - nC);  // cache row or tail slot
      in[u] = i < k_end;
      pos[u] = cache ? j : n + j;
      long long off;
      if constexpr (Paged) {
        const int page = min(max(pg[u], 0), p.num_pages - 1);
        off = cache ? page * p.c_p + pr[u] * p.c_s : static_cast<long long>(j) * p.t_s;
      } else {
        off = static_cast<long long>(j) * (cache ? p.c_s : p.t_s);
      }
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (in[u]) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>((cache ? kc : kt) + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>((cache ? vc : vt) + off));
      }
    }
    if constexpr (Paged) lookup(k0 + kUnroll * STEP);  // the next step's pages
    // logits: this lane's V-term partial dot products, summed over the LK lanes
    float s[kUnroll][CM];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[V];
      widen(kr[u], kf);
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) a = fmaf(qr[c][e], kf[e], a);
        s[u][c] = a;
      }
    }
#pragma unroll
    for (int o = 1; o < LK; o <<= 1)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < CM; ++c) s[u][c] += __shfl_xor_sync(kFull, s[u][c], o);
    // online softmax over the warp's keys of this step, one rescale per
    // column: the key groups share one running max, so each keeps partial
    // sums at the same scale and they merge by plain addition at the end
    float vf[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) widen(vr[u], vf[u]);
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      bool ok[kUnroll];
      float mx = m[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        ok[u] = in[u] && pos[u] >= c_lo[c] && pos[u] <= c_hi[c];
        if (ok[u]) mx = fmaxf(mx, s[u][c]);
      }
#pragma unroll
      for (int o = LK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float corr = expf(m[c] - mx);
      float pr[kUnroll];
      float zs = z[c] * corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pr[u] = ok[u] ? expf(s[u][c] - mx) : 0.f;
        zs += pr[u];
      }
      z[c] = zs;
      m[c] = mx;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a = acc[c][e] * corr;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(pr[u], vf[u][e], a);
        acc[c][e] = a;
      }
    }
  }

  // add up the warp's key groups (lanes li + LK k), which share m
#pragma unroll
  for (int o = LK; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      z[c] += __shfl_xor_sync(kFull, z[c], o);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[c][e] += __shfl_xor_sync(kFull, acc[c][e], o);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < CM; ++c) {
#pragma unroll
      for (int e = 0; e < V; ++e) Wacc[warp][c * D + li * V + e] = acc[c][e];
      if (li == 0) Wm[warp][c] = m[c], Wz[warp][c] = z[c];
    }
  }
  __syncthreads();
  // merge the warps, in order, into this block's partial
  for (int e = tid; e < nc * D; e += kThreads) {
    const int c = e / D;
    float mx = Wm[0][c];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, Wm[i][c]);
    float zs = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const float f = expf(Wm[i][c] - mx);
      zs += Wz[i][c] * f;
      a += Wacc[i][e] * f;
    }
    Bacc[e] = a;
    if (e % D == 0) Bm[c] = mx, Bz[c] = zs;
  }
  cluster.sync();  // every rank's partial is written and visible

  // merge the ranks, in order, over this rank's slice of the outputs
  T* o = static_cast<T*>(p.o);
  const int tot = nc * D, per = (tot + ns - 1) / ns;
  const int e_end = min((rank + 1) * per, tot);
  for (int e = rank * per + tid; e < e_end; e += kThreads) {
    const int c = e / D;
    float mi[kMaxSplits], zi[kMaxSplits], ai[kMaxSplits];
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < ns) {
        mi[i] = *cluster.map_shared_rank(&Bm[c], i);
        zi[i] = *cluster.map_shared_rank(&Bz[c], i);
        ai[i] = *cluster.map_shared_rank(&Bacc[e], i);
      }
    }
    float mx = mi[0];
#pragma unroll
    for (int i = 1; i < kMaxSplits; ++i)
      if (i < ns) mx = fmaxf(mx, mi[i]);
    float zs = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxSplits; ++i) {
      if (i < ns) {
        const float f = expf(mi[i] - mx);
        zs += zi[i] * f;
        a += ai[i] * f;
      }
    }
    o[Ocol[c] + (e - c * D)] = from_f32<T>(a / fmaxf(zs, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// Launch the (T, D) instance `kernel` over (NS * Hkv, B, column chunks) in
// clusters of NS blocks.
template <typename T, int D>
inline int launch(void (*kernel)(Params), const Params& p, int B, int Hkv,
                  int ns, cudaStream_t s) {
  constexpr int CM = Shape<T, D>::CM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * ns, B, (p.T * p.G + CM - 1) / CM);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ns;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

}  // namespace kvsplit

// Instantiate a __global__ wrapper of kvsplit::attend named NAME (PAGED:
// true for a paged pool), and NAME_dispatch(dtype, D, ...) that launches its
// (dtype, head dim) instance in clusters of ns blocks (1 <= ns <= 8).
#define UV_KV_SPLIT_KERNEL(NAME, PAGED)                                                  \
  template <typename T, int D>                                                           \
  __global__ void __launch_bounds__(kvsplit::kThreads) NAME(const kvsplit::Params p) {   \
    kvsplit::attend<T, D, PAGED>(p);                                                     \
  }                                                                                      \
  static int NAME##_dispatch(int dtype, int D, const kvsplit::Params& p, int B, int Hkv, \
                             int ns, cudaStream_t s) {                                   \
    if (ns < 1 || ns > kvsplit::kMaxSplits) return cudaErrorInvalidValue;                \
    if (dtype == UV_F32 && D == 64)                                                      \
      return kvsplit::launch<float, 64>(NAME<float, 64>, p, B, Hkv, ns, s);              \
    if (dtype == UV_F32 && D == 128)                                                     \
      return kvsplit::launch<float, 128>(NAME<float, 128>, p, B, Hkv, ns, s);            \
    if (dtype == UV_BF16 && D == 64)                                                     \
      return kvsplit::launch<__nv_bfloat16, 64>(NAME<__nv_bfloat16, 64>, p, B, Hkv, ns, s); \
    if (dtype == UV_BF16 && D == 128)                                                    \
      return kvsplit::launch<__nv_bfloat16, 128>(NAME<__nv_bfloat16, 128>, p, B, Hkv, ns, s); \
    return cudaErrorInvalidValue;                                                        \
  }
