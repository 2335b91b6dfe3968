// Skinny matrix product for decode: x (M <= 32, K) times w (K, N) -> (M, N).
//
// Replaces ultravox_tpu/ops/pallas/decode_matmul.py:decode_matmul (unwired
// in the reference; the port keeps lora.py's w8a16 product as it is).
// Numerics follow it: x is bf16 or fp32, w bf16 or int8 and cast to x's
// dtype (exact in every supported pair, as is each product in fp32), sums
// in fp32, an optional per-output-channel scale (fp32 or bf16) multiplies
// the fp32 sum, then the cast to the output dtype. Any K and N.
//
// Bound on the card: bytes. At M = 4 a weight byte meets 4-8 flops, far
// under the ~295 flop/byte ridge, so the least time is one read of w. At
// decode sizes (a few MB) what sets the time is how many bytes are in
// flight and how long the chain of dependent steps is. Design:
//
//   1. One launch per call. The grid is (CS, column tiles), launched in
//      clusters of CS <= 8 blocks along x (a plain launch at CS = 1). A
//      block's 4 warps stand WN = 1 or 4 side by side along N and 4 / WN
//      deep along K; the CS ranks of a cluster split K further, so each
//      warp streams one contiguous run of KW rows (a multiple of 16). Each
//      warp leaves its fp32 sums in shared memory; after one cluster
//      barrier each rank adds, for its slice of the tile, every rank's and
//      every warp's sums in a fixed order through distributed shared
//      memory and writes the output.
//      No fp32 partial goes to device memory, no second kernel, no
//      atomics: two runs are bit-equal. The wrapper's plan takes the
//      smallest cluster (1, 2, 4, 8), then WN = 4 before 1, that gives the
//      card 1.5 blocks per SM: on the H100 the fewer and longer the runs
//      of K the faster a large product streams (gate/up bf16 at 1, 2, 4, 8
//      ranks: 0.0278, 0.0281, 0.0297, 0.0355 ms), WN = 4 reads 512
//      contiguous bytes of each row where the tile is wide (lm_head bf16
//      0.1770 against 0.1804 ms at WN = 1), and a small product needs the
//      8-way split to have enough loads in flight (qkv_proj bf16 at 1, 2,
//      4, 8 ranks: 0.0170, 0.0121, 0.0107, 0.0107 ms). (Card ms at 4 rows,
//      ultravox_torch/scripts/compare_kernels.py --sweep-splits, NVIDIA
//      H100 80GB HBM3 at 700 W.)
//   2. Bytes in flight: each lane loads its weight straight into
//      registers, 16 bytes from each of 4 K rows a round, with the next
//      rounds' loads issued before the current round's arithmetic (two
//      rounds a stage at M <= 8, double-buffered: up to 256 bytes a lane).
//      A lane-private cp.async ring in shared memory (6 stages) measured
//      1.2-1.7x slower at every product and was taken out. The scale is
//      read into shared memory at the start, so no load waits at the end.
//   3. bf16 x runs on the tensor cores, as out^T = w^T x^T with
//      mma.sync.m16n8k16: the A operand is 16 weight columns x 16 K rows,
//      the B operand 16 K rows of x^T by 8 rows of x (M <= 8 wastes at most
//      7 of 8 B columns, not 15 of 16 as x in A would). A needs k-adjacent
//      pairs of one column; a row-major weight gives n-adjacent ones. Since
//      the sum over k may take its k in any order, lane (g, t) of the warp
//      loads K rows k0 + 4t .. k0 + 4t + 3 at columns g E .. g E + E - 1
//      and calls them the mma's k slots 2t, 2t+1, 2t+8, 2t+9, and B reads
//      x at the same k (one 8-byte load of x row g); row g / g + 8 of mma
//      tile j is column 2j / 2j + 1 of the lane's E. Then bf16 A is one
//      byte_perm per pair, and int8 is made bf16 exactly in registers (the
//      byte under the exponent of 2^23 as fp32, 2^23 + 128 subtracted, the
//      top halves of two fp32 paired): 2.75 lane instructions per int8 byte
//      plus one mma per 256 weights, against the CUDA-core loop's ~6.5
//      (4 FMAs and 2 conversions a byte at M = 4, x reread each row). The
//      reckoning for int8 gate/up at M = 4: 33.5 M weights x 2.75 / 32
//      lanes / (528 schedulers x ~1.75 GHz) ~ 3.1 us of issue, under its
//      10.1 us bound, where the CUDA-core loop needed ~7.4 us. Each
//      mma starts from zero and its 16-term result is added to the running
//      fp32 sum with FADD, so the accumulation rounds as a plain fp32 sum
//      (the tensor core's own accumulate need not round like FADD).
//   4. fp32 x stays on the CUDA cores (on the tensor cores it would be
//      TF32): a lane owns CPT neighbouring columns, loads them as one vector
//      of up to 16 bytes, makes them fp32 with integer ops and keeps
//      MT x CPT sums (at most 32), x read as a warp-wide broadcast.
//   5. A ragged N or a weight pointer off the vector's alignment takes an
//      instance whose lanes assemble the same registers from element loads
//      (the tensor-core path) or own one column each (the CUDA-core path).
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kRound = 16;  // K rows a warp takes per round (one mma depth)
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxAcc = 32;  // fp32 sums per lane on the CUDA cores

enum { W_BF16 = 1, W_INT8 = 2, SCALE_NONE = -1 };

struct Params {
  const void* x;
  long long x_stride;
  const void* w;
  const void* scale;
  int scale_code;
  void* out;
  int out_code;
  int M, K, N, kw;  // kw: K rows per warp
  int wn;  // warps of a block side by side along N (1 or 4); the rest split K
  bool x_vec;  // bf16 x whose rows load as 8-byte vectors
};

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<1> { using type = unsigned char; };

// the raw element type of W (its bits)
template <typename W> struct Bits { using type = unsigned short; };
template <> struct Bits<int8_t> { using type = unsigned char; };

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

// E elements of W at w[off ..], as one raw vector (VEC) or from element
// loads, each guarded by i < left; all zero unless ok
template <typename W, int E, bool VEC>
__device__ __forceinline__ typename Raw<E * sizeof(W)>::type load_w(const W* __restrict__ w,
                                                                    size_t off, bool ok,
                                                                    int left) {
  using V = typename Raw<E * sizeof(W)>::type;
  if constexpr (VEC) {
    return ok ? __ldg(reinterpret_cast<const V*>(w + off)) : V{};
  } else {
    using B = typename Bits<W>::type;
    union {
      V v;
      B e[E];
    } u;
    const B* p = reinterpret_cast<const B*>(w) + off;
#pragma unroll
    for (int i = 0; i < E; ++i) u.e[i] = ok && i < left ? p[i] : B(0);
    return u.v;
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

// The tile's scale values into shared memory (1 where there is none), read
// at the start so that the load overlaps the main loop.
__device__ __forceinline__ void load_scale(float* scale, const Params& p, int n0, int bn) {
  for (int j = threadIdx.x; j < bn; j += kThreads)
    scale[j] = p.scale_code == SCALE_NONE || n0 + j >= p.N ? 1.f
                                                           : load_any(p.scale, p.scale_code, n0 + j);
}

// The block's sums `part` -> out. The block covers BN columns; each of its
// KP K parts (rows of warps) wrote its fp32 sums for them at
// part[KP][ROWS][BN]. After one barrier (the cluster's, or the block's at
// CS = 1), each rank takes a contiguous slice of the tile's M x BN outputs
// and adds, rank by rank in order and within a rank K part by K part, the
// sums of every rank through distributed shared memory, times the scale,
// cast.
template <int ROWS, int BN, int KP>
__device__ __forceinline__ void merge_store(float* part, const float* scale, const Params& p,
                                            int n0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ns = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kSlot = ROWS * BN;
  if (ns > 1)
    cluster.sync();  // every rank's sums are written and visible
  else
    __syncthreads();
  const int tot = p.M * BN, per = (tot + ns - 1) / ns;
  const int e_end = min((rank + 1) * per, tot);
  for (int e = rank * per + threadIdx.x; e < e_end; e += kThreads) {
    const int c = e % BN;
    if (n0 + c >= p.N) continue;
    float a = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float* src = ns > 1 ? cluster.map_shared_rank(part, i) : part;
#pragma unroll
      for (int w = 0; w < KP; ++w) a += src[w * kSlot + e];
    }
    if (p.scale_code != SCALE_NONE) a *= scale[c];
    store_any(p.out, p.out_code, static_cast<size_t>(e / BN) * p.N + n0 + c, a);
  }
  if (ns > 1) cluster.sync();  // no block leaves while another still reads its sums
}

// the first K row of the warps of K part wk (of KP) of this block
template <int KP>
__device__ __forceinline__ int k_begin(const Params& p, int wk) {
  return min(p.K, (static_cast<int>(cg::this_cluster().block_rank()) * KP + wk) * p.kw);
}

// ---- bf16 x: tensor cores -------------------------------------------------

// One round's registers of a lane: 4 K rows of E weight columns, and the
// B fragments of x (row g + 8 mc, the same 4 K rows) for each of MC
// 8-row groups of x.
template <typename W, int MC, int E>
struct Round {
  typename Raw<E * sizeof(W)>::type w[4];
  uint32_t x[MC][2];
};

template <typename W, int MC, int E, bool VEC>
__device__ __forceinline__ void load_round(Round<W, MC, E>& r, const Params& p, int k, int r1,
                                           int n_lane) {
  const W* __restrict__ w = static_cast<const W*>(p.w);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kt = k + 4 * t;
  const bool live = n_lane < p.N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r.w[i] = load_w<W, E, VEC>(w, static_cast<size_t>(kt + i) * p.N + n_lane,
                               live && kt + i < r1, p.N - n_lane);
  const unsigned short* __restrict__ x = static_cast<const unsigned short*>(p.x);
#pragma unroll
  for (int mc = 0; mc < MC; ++mc) {
    const int m = g + 8 * mc;
    r.x[mc][0] = r.x[mc][1] = 0u;
    if (m >= p.M) continue;
    const unsigned short* xr = x + m * p.x_stride + kt;
    if (p.x_vec && kt + 3 < r1) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(xr));
      r.x[mc][0] = v.x, r.x[mc][1] = v.y;
    } else {
      unsigned int e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) e[q] = kt + q < r1 ? xr[q] : 0u;
      r.x[mc][0] = e[0] | e[1] << 16, r.x[mc][1] = e[2] | e[3] << 16;
    }
  }
}

// int8 byte c of a word already xor'ed with 0x80808080, as the bits of an
// exact fp32 (its top half is then the same value in bf16)
__device__ __forceinline__ unsigned int i8_f32_bits(unsigned int u, int c) {
  return __float_as_uint(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 | c)) - 8388736.f);
}

template <typename W, int MC, int E>
__device__ __forceinline__ void mma_round(const Round<W, MC, E>& r, float (&acc)[MC][E / 2][4]) {
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {
    uint32_t a[4];
    if constexpr (sizeof(W) == 2) {  // word j of a row holds columns 2j, 2j + 1
      const uint32_t w0 = word(r.w[0], j), w1 = word(r.w[1], j);
      const uint32_t w2 = word(r.w[2], j), w3 = word(r.w[3], j);
      a[0] = __byte_perm(w0, w1, 0x5410), a[1] = __byte_perm(w0, w1, 0x7632);
      a[2] = __byte_perm(w2, w3, 0x5410), a[3] = __byte_perm(w2, w3, 0x7632);
    } else {  // word j / 2 holds them, at bytes 2 (j % 2) and 2 (j % 2) + 1
      const int c = 2 * (j % 2);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) u[i] = word(r.w[i], j / 2) ^ 0x80808080u;
      a[0] = __byte_perm(i8_f32_bits(u[0], c), i8_f32_bits(u[1], c), 0x7632);
      a[1] = __byte_perm(i8_f32_bits(u[0], c + 1), i8_f32_bits(u[1], c + 1), 0x7632);
      a[2] = __byte_perm(i8_f32_bits(u[2], c), i8_f32_bits(u[3], c), 0x7632);
      a[3] = __byte_perm(i8_f32_bits(u[2], c + 1), i8_f32_bits(u[3], c + 1), 0x7632);
    }
#pragma unroll
    for (int mc = 0; mc < MC; ++mc) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tile::mma_bf16(d, a, r.x[mc][0], r.x[mc][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mc][j][e] += d[e];
    }
  }
}

// Blocks an SM must hold, which caps the registers so that ptxas spills
// nothing: 4 (128 registers) for bf16 vectors at M <= 8, 3 for int8's 16
// columns a lane there, else 2 (more sums, or element loads)
template <typename W, int MC, bool VEC>
constexpr int kMinBlocks = VEC && MC == 1 ? (sizeof(W) == 2 ? 4 : 3) : 2;

// MC: 8-row groups of x (M <= 8 MC); E: weight columns per lane (a warp
// covers 8 E); VEC: E columns load as one vector; WN: warps side by side
// along N (the block covers WN x 8 E columns, its other 4 / WN warps split K).
template <typename W, int MC, int E, bool VEC, int WN>
__global__ void __launch_bounds__(kThreads, kMinBlocks<W, MC, VEC>)
decode_matmul_mma_kernel(const Params p) {
  constexpr int WC = 8 * E, ROWS = 8 * MC, BN = WN * WC, KP = kWarps / WN;
  constexpr int U = MC == 1 ? 2 : 1;  // rounds a stage
  __shared__ __align__(16) float part[kWarps * ROWS * WC];
  __shared__ float scale[kWarps * WC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  const int n0 = blockIdx.y * BN, n_lane = n0 + wn * WC + g * E;
  const int r0 = k_begin<KP>(p, wk), r1 = min(p.K, r0 + p.kw);
  const int rounds = (r1 - r0 + kRound - 1) / kRound;

  float acc[MC][E / 2][4];
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int j = 0; j < E / 2; ++j) acc[mc][j][0] = acc[mc][j][1] = acc[mc][j][2] = acc[mc][j][3] = 0.f;

  Round<W, MC, E> cur[U], nxt[U];
#pragma unroll
  for (int u = 0; u < U; ++u) load_round<W, MC, E, VEC>(cur[u], p, r0 + u * kRound, r1, n_lane);
  load_scale(scale, p, n0, BN);  // read at the end; its load overlaps the loop
  for (int i = 0; i < rounds; i += U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_round<W, MC, E, VEC>(nxt[u], p, r0 + (i + U + u) * kRound, r1, n_lane);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u < rounds) mma_round(cur[u], acc);
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }

  // the mma C layout: row g / g + 8 of tile j is column g E + 2j / 2j + 1,
  // column 2t / 2t + 1 of group mc is row 8 mc + 2t / 2t + 1 of x
  float* mine = part + wk * ROWS * BN + wn * WC;
#pragma unroll
  for (int mc = 0; mc < MC; ++mc)
#pragma unroll
    for (int j = 0; j < E / 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(8 * mc + 2 * t + (e & 1)) * BN + g * E + 2 * j + (e >> 1)] = acc[mc][j][e];
  merge_store<ROWS, BN, KP>(part, scale, p, n0);
}

// ---- fp32 x: CUDA cores ---------------------------------------------------

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
template <typename W, int MT, int CPT>
__device__ __forceinline__ void accumulate(const float* __restrict__ x, long long x_stride,
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
      for (int m = 0; m < MT; ++m) a[m] = m < M ? x[m * x_stride + kr] : 0.f;
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

// MT: sum rows (at least M); CPT: columns per lane (a warp covers 32 CPT)
template <typename W, int MT, int CPT>
__global__ void __launch_bounds__(kThreads)
decode_matmul_kernel(const Params p) {
  static_assert(MT * CPT <= kMaxAcc, "too many sums per lane");
  constexpr int BN = 32 * CPT;  // the block's warps all split K
  __shared__ __align__(16) float part[kWarps * MT * BN];
  __shared__ float scale[BN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * BN, col = n0 + lane * CPT;
  const int r0 = k_begin<kWarps>(p, warp), r1 = min(p.K, r0 + p.kw);

  load_scale(scale, p, n0, BN);
  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;
  if (col < p.N)  // N % CPT == 0: a lane's columns are all in or all out
    accumulate(static_cast<const float*>(p.x), p.x_stride, static_cast<const W*>(p.w) + col, p.M,
               p.N, r0, r1, acc);
  float* mine = part + warp * MT * BN;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) mine[m * BN + lane * CPT + c] = acc[m][c];
  merge_store<MT, BN, kWarps>(part, scale, p, n0);
}

// ---- launch ---------------------------------------------------------------

// grid (cs, column tiles) in clusters of cs blocks; a cluster of one is a
// plain launch
int launch(void (*kernel)(Params), const Params& p, int cs, int bn, cudaStream_t stream) {
  const dim3 grid(cs, (p.N + bn - 1) / bn, 1);
  if (cs == 1) {
    kernel<<<grid, kThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// vector loads with 1 or 4 warps along N
template <typename W, int MC, int E>
int launch_vec(const Params& p, int cs, cudaStream_t s) {
  if (p.wn == 1) return launch(decode_matmul_mma_kernel<W, MC, E, true, 1>, p, cs, 8 * E, s);
  if (p.wn == 4) return launch(decode_matmul_mma_kernel<W, MC, E, true, 4>, p, cs, 32 * E, s);
  return cudaErrorInvalidValue;
}

// element loads (a ragged N, an unaligned weight) with 1 warp along N
template <typename W, int MC, int E>
int launch_mma(bool vec, const Params& p, int cs, cudaStream_t s) {
  if (vec) return launch_vec<W, MC, E>(p, cs, s);
  return p.wn == 1 ? launch(decode_matmul_mma_kernel<W, MC, E, false, 1>, p, cs, 8 * E, s)
                   : cudaErrorInvalidValue;
}

// the instances the wrapper's plan picks: bf16 8 columns a lane; int8 16,
// or 8 at 32 rows or (with vectors) where 16 gives too few blocks
template <typename W>
int dispatch_mma(int rows, int e, bool vec, const Params& p, int cs, cudaStream_t s) {
  if constexpr (sizeof(W) == 2) {
    if (e != 8) return cudaErrorInvalidValue;
    switch (rows) {
      case 8: return launch_mma<W, 1, 8>(vec, p, cs, s);
      case 16: return launch_mma<W, 2, 8>(vec, p, cs, s);
      case 32: return launch_mma<W, 4, 8>(vec, p, cs, s);
    }
  } else {
    if (rows == 8 && e == 16) return launch_mma<W, 1, 16>(vec, p, cs, s);
    if (rows == 16 && e == 16) return launch_mma<W, 2, 16>(vec, p, cs, s);
    if (rows == 8 && e == 8 && vec) return launch_vec<W, 1, 8>(p, cs, s);
    if (rows == 16 && e == 8 && vec) return launch_vec<W, 2, 8>(p, cs, s);
    if (rows == 32 && e == 8) return launch_mma<W, 4, 8>(vec, p, cs, s);
  }
  return cudaErrorInvalidValue;
}

// CPT: the vector width the wrapper planned (MT * CPT <= 32, at most 16
// bytes), or 1 where N or the weight's address does not allow a vector
template <typename W, int MT>
int dispatch_cpt(int cpt, const Params& p, int cs, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(W) < kMaxAcc / MT ? 16 / sizeof(W) : kMaxAcc / MT;
  if (cpt == kVec) return launch(decode_matmul_kernel<W, MT, kVec>, p, cs, 32 * kVec, s);
  if (cpt == 1) return launch(decode_matmul_kernel<W, MT, 1>, p, cs, 32, s);
  return cudaErrorInvalidValue;
}

template <typename W>
int dispatch_cuda_cores(int mt, int cpt, const Params& p, int cs, cudaStream_t s) {
  switch (mt) {
    case 1: return dispatch_cpt<W, 1>(cpt, p, cs, s);
    case 4: return dispatch_cpt<W, 4>(cpt, p, cs, s);
    case 8: return dispatch_cpt<W, 8>(cpt, p, cs, s);
    case 16: return dispatch_cpt<W, 16>(cpt, p, cs, s);
    case 32: return dispatch_cpt<W, 32>(cpt, p, cs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) fp32 or bf16 (x_code), rows x_stride elements apart; w: (K, N)
// bf16 or int8 (w_code), contiguous; scale: (N,) fp32 or bf16, or null
// (scale_code -1); out: (M, N) contiguous, fp32 or bf16 (out_code).
// rows: the sums' row count (bf16 x: 8, 16 or 32; fp32 x: 1, 4, 8, 16 or
// 32; at least M); e: weight columns per lane; vec: whether they load as
// one vector (the weight's address and N allow it); wn: warps of a block
// side by side along N (1, or 4 with bf16 x and vectors), the other
// 4 / wn splitting K; cs:
// blocks per cluster (1-8), which split K too; kw: K rows per warp (a
// multiple of 16), with cs * (4 / wn) runs of kw covering K and one fewer
// rank's not.
UV_EXPORT int uv_decode_matmul(const void* x, long long x_stride, int x_code, const void* w,
                               int w_code, const void* scale, int scale_code, void* out,
                               int out_code, int M, int K, int N, int rows, int e, int vec,
                               int wn, int cs, int kw, void* stream) {
  const int wsize = w_code == W_INT8 ? 1 : 2;
  const long long kp = wn > 0 ? kWarps / wn : 0;
  if (M <= 0 || M > rows || K <= 0 || N <= 0 || e <= 0 || (wn != 1 && wn != 4) ||
      cs < 1 || cs > kMaxCluster || kw <= 0 || kw % kRound || cs * kp * kw < K ||
      (cs - 1) * kp * kw >= K || (vec && (N % e || reinterpret_cast<uintptr_t>(w) % (e * wsize))))
    return cudaErrorInvalidValue;
  Params p{x, x_stride, w, scale, scale_code, out, out_code, M, K, N, kw, wn, false};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == UV_BF16) {
    p.x_vec = reinterpret_cast<uintptr_t>(x) % 8 == 0 && x_stride % 4 == 0;
    if (w_code == W_BF16) return dispatch_mma<__nv_bfloat16>(rows, e, vec, p, cs, s);
    if (w_code == W_INT8) return dispatch_mma<int8_t>(rows, e, vec, p, cs, s);
  } else if (x_code == UV_F32 && (vec || e == 1) && wn == 1) {
    if (w_code == W_BF16) return dispatch_cuda_cores<__nv_bfloat16>(rows, e, p, cs, s);
    if (w_code == W_INT8) return dispatch_cuda_cores<int8_t>(rows, e, p, cs, s);
  }
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_decode_matmul)
