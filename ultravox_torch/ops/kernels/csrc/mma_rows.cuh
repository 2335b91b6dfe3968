// A BM x BN output tile of (rows, K) x (K, N) on the tensor cores, in bf16
// with fp32 sums (mma.sync.m16n8k16, csrc/mma_tile.cuh's primitives), for
// kernels whose left operand is made inside the kernel and never reaches
// HBM: the block's BM rows are resident in shared memory for the whole
// product (the caller makes them there, with layer_norm_rows or a gather of
// its own), and the weight streams through a STAGES-deep cp.async ring of
// BK x BN tiles. The caller writes its own epilogue from the accumulators
// (acc_row / acc_col give each element's place in the tile), or hands
// store_lines a value per element and a store per 16-byte line.
//
// Layout. The resident rows keep a pitch of K + 8 elements and the ring's
// tiles one of BN + 8 (mma_tile.cuh's convention: with K % 16 == 0 the eight
// rows one ldmatrix phase reads fall on eight bank groups). 2 x BM / 32
// warps: warp (wm, wn) owns rows [32 wm, 32 wm + 32) and columns
// [WN wn, WN wn + WN) of the tile, WN = BN / 2, as acc[mt][nt][e] in the mma
// C layout of mma_tile.cuh (16-row half mt, 8-column piece nt).
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"

namespace mma_rows {

using mma_tile::bf16;

constexpr int BK = 32;     // weight rows a ring stage holds
constexpr int STAGES = 3;  // stages of the ring
constexpr int kMaxK = 2048;  // widest row the tile takes
constexpr size_t kMaxSmem = 232448;  // the 227 KB a block may use on sm_90

template <int BM, int BN>
struct Tile {
  static_assert(BM % 32 == 0 && BN % 32 == 0, "32-row warp tiles, 16-column B fragments");
  static constexpr int kWarpsN = 2;
  static constexpr int kThreads = 32 * (BM / 32) * kWarpsN;
  static constexpr int kWN = BN / kWarpsN;  // columns a warp owns
  static constexpr int kNT = kWN / 8;       // its 8-column pieces
  static constexpr int kPitchB = BN + 8;
  static constexpr int kStage = BK * kPitchB;  // elements of one ring stage
};

// Dynamic shared memory of a block: the LN scale and bias (2 K fp32; none
// for a caller whose rows need no LayerNorm, `ln` false), then the resident
// rows and the ring, or the caller's BM x (BN + 8) epilogue staging tile
// where that is larger (it reuses both once the product is done).
inline size_t smem_bytes(int bm, int bn, int K, bool ln = true) {
  const size_t main = static_cast<size_t>(bm) * (K + 8) + static_cast<size_t>(STAGES) * BK * (bn + 8);
  const size_t stage = static_cast<size_t>(bm) * (bn + 8);
  return (ln ? 2 * K * sizeof(float) : 0) + (main > stage ? main : stage) * sizeof(bf16);
}

// Sum of the 8 bf16 values of a 16-byte piece, as a pairwise tree
__device__ __forceinline__ float sum8(const uint4& u) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  const float2 c = __bfloat1622float2(p[2]), d = __bfloat1622float2(p[3]);
  return ((a.x + a.y) + (b.x + b.y)) + ((c.x + c.y) + (d.x + d.y));
}

// Sum of squares of (v - m) over the 8 values of a piece, as a pairwise tree
__device__ __forceinline__ float sq8(const uint4& u, float m) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    q[i] = (v.x - m) * (v.x - m) + (v.y - m) * (v.y - m);
  }
  return (q[0] + q[1]) + (q[2] + q[3]);
}

// R rows of x at once per warp, each lane holding pieces lane, lane + 32,
// ... (at most PMAX) of each row in registers: R * PMAX 16-byte loads in
// flight, both reductions with R rows' shuffles interleaved, then each
// normalised piece stored once to A.
template <int BM, int THREADS, int R, int PMAX>
__device__ __forceinline__ void layer_norm_rows_r(bf16* A, const bf16* __restrict__ x, int row0,
                                                  int rows, int K, const float* lns,
                                                  const float* lnb, float eps) {
  constexpr int NW = THREADS / 32;
  static_assert(BM % (NW * R) == 0, "each warp takes whole groups of rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, pieces = K / 8;
  const float inv_k = 1.f / K;
  for (int r0 = warp * R; r0 < BM; r0 += NW * R) {
    uint4 v[R][PMAX];
    float s[R], q[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = row0 + r0 + i;
      const bf16* src = x + static_cast<size_t>(row < rows ? row : 0) * K;
      s[i] = q[i] = 0.f;
#pragma unroll
      for (int j = 0; j < PMAX; ++j) {
        const int c = lane + 32 * j;
        v[i][j] = make_uint4(0, 0, 0, 0);
        if (c < pieces && row < rows) v[i][j] = __ldg(reinterpret_cast<const uint4*>(src) + c);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < PMAX; ++j) s[i] += sum8(v[i][j]);  // zeros past the row add 0
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      s[i] *= inv_k;  // the mean
#pragma unroll
      for (int j = 0; j < PMAX; ++j)
        if (lane + 32 * j < pieces) q[i] += sq8(v[i][j], s[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
#pragma unroll
    for (int i = 0; i < R; ++i) q[i] = rsqrtf(q[i] * inv_k + eps);
#pragma unroll
    for (int j = 0; j < PMAX; ++j) {
      const int c = lane + 32 * j;
      if (c >= pieces) continue;
      const float4 s0 = *reinterpret_cast<const float4*>(lns + c * 8);
      const float4 s1 = *reinterpret_cast<const float4*>(lns + c * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(lnb + c * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(lnb + c * 8 + 4);
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[i][j]);
        uint4 u;
        uint32_t* o = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float2 f = __bfloat1622float2(e[t]);
          o[t] = mma_tile::pack_bf16((f.x - s[i]) * q[i] * sc[2 * t] + bi[2 * t],
                                     (f.y - s[i]) * q[i] * sc[2 * t + 1] + bi[2 * t + 1]);
        }
        *reinterpret_cast<uint4*>(A + (r0 + i) * (K + 8) + c * 8) = u;
      }
    }
  }
}

// LayerNorm of rows [row0, row0 + BM) of x (rows, K) into A (pitch K + 8):
// fp32 mean, then the centred variance, (x - mean) * rsqrt(var + eps) *
// scale + bias in fp32, rounded to bf16; the rows never reach HBM. Rows at
// or past `rows` come out as the bias: finite. Scale and bias (fp32) are
// first copied to `sb` (2 K floats of shared memory): read from global
// memory for every row, they would miss the small L1 that the streaming
// rows evict. K % 8 == 0, K <= kMaxK; x, scale and bias 16-byte aligned.
// Ends before any barrier: the caller syncs before A is read.
template <int BM, int THREADS>
__device__ __forceinline__ void layer_norm_rows(bf16* A, float* sb, const bf16* __restrict__ x,
                                                int row0, int rows, int K,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb, float eps) {
  for (int i = threadIdx.x; i < K / 4; i += THREADS) {
    reinterpret_cast<float4*>(sb)[i] = __ldg(reinterpret_cast<const float4*>(lns) + i);
    reinterpret_cast<float4*>(sb + K)[i] = __ldg(reinterpret_cast<const float4*>(lnb) + i);
  }
  __syncthreads();
  // rows a warp holds at once, so that ~24 16-byte loads a lane are in flight
  constexpr int RW = BM / (THREADS / 32);  // rows of each warp
  if (K <= 32 * 8 * 3)
    layer_norm_rows_r<BM, THREADS, (RW < 8 ? RW : 8), 3>(A, x, row0, rows, K, sb, sb + K, eps);
  else if (K <= 32 * 8 * 4)
    layer_norm_rows_r<BM, THREADS, (RW < 4 ? RW : 4), 4>(A, x, row0, rows, K, sb, sb + K, eps);
  else
    layer_norm_rows_r<BM, THREADS, 2, kMaxK / 256>(A, x, row0, rows, K, sb, sb + K, eps);
}

// Weight rows [k0, k0 + BK) x columns [n0, n0 + BN) of w (K, N) into a ring
// stage, asynchronously; rows past K and columns past N are zero-filled.
// N % 8 == 0 and w 16-byte aligned. The caller commits.
template <int BN, int THREADS>
__device__ __forceinline__ void load_stage(bf16* S, const bf16* __restrict__ w, int k0, int K,
                                           int N, int n0) {
  constexpr int kPieces = BN / 8;  // 16-byte pieces of a stage row
  static_assert(BK * kPieces % THREADS == 0, "every thread copies as many pieces");
#pragma unroll
  for (int i = 0; i < BK * kPieces / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, kr = e / kPieces, c = e % kPieces;
    const int k = k0 + kr, n = n0 + c * 8;
    const bool ok = k < K && n < N;
    mma_tile::cp_async16(S + kr * (BN + 8) + c * 8, ok ? w + static_cast<size_t>(k) * N + n : w,
                         ok);
  }
}

// Issue ring stages 0 .. STAGES - 2 (one committed group each, empty past
// K), before the caller makes its rows, so the first weight tiles are in
// flight meanwhile.
template <int BM, int BN>
__device__ __forceinline__ void prefetch(bf16* ring, const bf16* __restrict__ w, int K, int N,
                                         int n0) {
  using TL = Tile<BM, BN>;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s * BK < K) load_stage<BN, TL::kThreads>(ring + s * TL::kStage, w, s * BK, K, N, n0);
    mma_tile::cp_async_commit();
  }
}

// acc += A[rows of this warp, k0 : k0 + 16 * KS] . S[0 : 16 * KS, columns of
// this warp] for a ring stage S: every fragment of the KS 16-deep steps is
// loaded first, then the mmas run in ascending k.
template <int BN, int KS, int NT>
__device__ __forceinline__ void stage_product(float (&acc)[2][NT][4], const bf16* a_base,
                                              int a_pitch, int k0, const bf16* S, int b_off) {
  constexpr int PB = BN + 8;
  uint32_t a[KS][2][4], b[KS][NT / 2][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_tile::ldsm_x4(a[kk][mt], a_base + mt * 16 * a_pitch + k0 + kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
      mma_tile::ldsm_x4_trans(b[kk][np], S + kk * 16 * PB + b_off + np * 16);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tile::mma_bf16(acc[mt][2 * np], a[kk][mt], b[kk][np][0], b[kk][np][1]);
        mma_tile::mma_bf16(acc[mt][2 * np + 1], a[kk][mt], b[kk][np][2], b[kk][np][3]);
      }
}

// acc = A (BM resident rows, pitch K + 8) . w[:, n0 : n0 + BN] over K, in
// 16-deep steps in ascending order (a fixed order: repeats are bit-equal).
// Call after prefetch() and once the rows are written (the first barrier
// here publishes them). Ends with every cp.async landed and a barrier, so
// the caller may reuse A and the ring. K % 16 == 0: a last stage may hold
// one 16-deep step.
template <int BM, int BN>
__device__ __forceinline__ void product(float (&acc)[2][Tile<BM, BN>::kNT][4], const bf16* A,
                                        int K, bf16* ring, const bf16* __restrict__ w, int N,
                                        int n0) {
  using TL = Tile<BM, BN>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / TL::kWarpsN, wn = warp % TL::kWarpsN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < TL::kNT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const bf16* a_base = A + (wm * 32 + (lane & 15)) * (K + 8) + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * TL::kPitchB + wn * TL::kWN +
                    (lane >> 4) * 8;
  const int KT = (K + BK - 1) / BK;
  for (int kt = 0; kt < KT; ++kt) {
    mma_tile::cp_async_wait<STAGES - 2>();  // stage kt has landed (this thread's pieces)
    __syncthreads();  // ... everyone's; and everyone is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage<BN, TL::kThreads>(ring + (nk % STAGES) * TL::kStage, w, nk * BK, K, N, n0);
    mma_tile::cp_async_commit();
    const bf16* S = ring + (kt % STAGES) * TL::kStage;
    if (kt * BK + BK <= K)
      stage_product<BN, BK / 16, TL::kNT>(acc, a_base, K + 8, kt * BK, S, b_off);
    else
      stage_product<BN, 1, TL::kNT>(acc, a_base, K + 8, kt * BK, S, b_off);
  }
  mma_tile::cp_async_wait<0>();
  __syncthreads();
}

// Row (0 .. BM) and column (0 .. BN) within the block's tile of this lane's
// accumulator element acc[mt][nt][e]
template <int BM, int BN>
__device__ __forceinline__ int acc_row(int mt, int e) {
  return (threadIdx.x >> 5) / Tile<BM, BN>::kWarpsN * 32 + mt * 16 + ((threadIdx.x & 31) >> 2) +
         8 * (e >> 1);
}
template <int BM, int BN>
__device__ __forceinline__ int acc_col(int nt, int e) {
  return (threadIdx.x >> 5) % Tile<BM, BN>::kWarpsN * Tile<BM, BN>::kWN + nt * 8 +
         2 * (threadIdx.x & 3) + (e & 1);
}

// Where this lane's 16-byte output line (mt, p) of store_lines lies in the
// tile: its row (0 .. BM) and its first column (0 .. BN)
template <int BM, int BN>
__device__ __forceinline__ int line_row(int mt) {
  return acc_row<BM, BN>(mt, 2 * (threadIdx.x & 1));
}
template <int BM, int BN>
__device__ __forceinline__ int line_col(int p) {
  const int q = threadIdx.x & 3;
  return acc_col<BM, BN>(2 * p + q / 2, 0) - 2 * q;  // the start of the line's 8-column piece
}

// The tile from the accumulators as 16-byte lines of 8 bf16 values, each
// lane holding whole lines: for each 16-row half mt and pair of 8-column
// pieces (2p, 2p + 1) a quad of lanes holds four lines (pieces 2p and
// 2p + 1, rows g and g + 8), each lane a 4-byte word of every line; after a
// 4 x 4 transpose by shuffles lane q holds line q whole. Each element is
// value(acc, nt, j) rounded to bf16 (nt: its 8-column piece, j: its column
// parity, for a value that depends on the column); each lane then calls
// emit(mt, p, row, col, line) with the line's place in the tile (line_row,
// line_col), inside the output or not: the caller masks.
template <int BM, int BN, typename Value, typename Emit>
__device__ __forceinline__ void store_lines(const float (&acc)[2][Tile<BM, BN>::kNT][4],
                                            Value value, Emit emit) {
  constexpr int NT = Tile<BM, BN>::kNT;
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t word[4];  // line i: piece 2p + i / 2, row half i % 2
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 2 * p + i / 2, e = 2 * (i % 2);
        word[i] = mma_tile::pack_bf16(value(acc[mt][nt][e], nt, 0),
                                      value(acc[mt][nt][e + 1], nt, 1));
      }
      // round s: lane j sends its word of line (j - s) & 3, lane q takes
      // from lane (q + s) & 3 that lane's word of line q
      uint32_t line[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = (q - s) & 3, j = (q + s) & 3;
        const uint32_t send = k == 0 ? word[0] : k == 1 ? word[1] : k == 2 ? word[2] : word[3];
        const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | j);
#pragma unroll
        for (int t = 0; t < 4; ++t) line[t] = j == t ? got : line[t];
      }
      emit(mt, p, line_row<BM, BN>(mt), line_col<BM, BN>(p),
           make_uint4(line[0], line[1], line[2], line[3]));
    }
}

}  // namespace mma_rows
