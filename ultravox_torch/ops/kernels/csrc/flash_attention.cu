// Differentiable self-attention for training: forward and backward kernels.
//
// Replaces the TPU kernel ultravox_tpu/ops/pallas/flash_attention.py:
// flash_attention (forward _fwd_kernel, backward _bwd_kernel behind a
// jax.custom_vjp). q (B, T, H, D), k/v (B, T, Hkv, D) with GQA (kv head =
// h / group), all contiguous in that layout; masks are computed from
// scalars: key j is hidden from query row i (its absolute position) when
// j >= lengths[b] (if given), when causal and j > i or (window > 0 and
// i - j >= window), or when j / latency_block > i / latency_block.
//
// Numerics follow the Pallas kernels: logits = (q . k) in fp32 times
// scale*log2(e), hidden entries set to the finite NEG_INF (-0.7 FLT_MAX),
// keys at or past T to -inf, exp2 against the row's global maximum, the row
// sum over the unrounded exponentials, probabilities rounded to the value
// dtype before the PV product, fp32 accumulation, division by the row sum
// last. A row with no visible key (lengths[b] == 0, or a padding row past
// length + window) therefore averages v over all T keys, as the Pallas
// kernel does, and its output is finite. The backward keeps the Pallas
// rounding points: p = exp2(s - m) / z from the forward's stats;
// dv += p.astype(T)^T do; dp = do v^T in fp32; ds = p (dp - rowsum(do o)),
// zero where hidden; ds16 = (ds * scale) rounded to T; dq = ds16 k and
// dk += ds16^T q, fp32-accumulated, cast to T at the end. No atomics: two
// runs give bit-equal outputs.
//
// Bound on the H100 at the training shapes (bf16): the decoder's
// (8, 190, 32/8 heads, 64), causal, is bound by bytes (4.8 us forward, 9.4
// us backward for q, k, v, o, do and the gradients once each, against
// 1.2 / 3.0 us of tensor-core work); the encoder's (8, 500, 12, 64)
// backward by operations (15.4 GFLOP, 15.5 us at 989 TFLOP/s). Either way
// the work is products of 64-row tiles, so the bf16 kernels run them on the
// tensor cores and keep every logit in registers. What is left of the time
// then is the per-element work between the products (mask, exp2, division,
// bf16 packing) and each tile's wait, since a block runs only 1 to 8 tiles
// at these shapes: hence the two-compare mask and one reciprocal per row.
//
// bf16 design (mma_tile.cuh): 4 warps per block, 64-row tiles, each warp 16
// rows; tiles of q, k, v and do come in by cp.async, 16 bytes a thread,
// into padded shared memory (no ldmatrix bank conflicts), the next tile's
// copy in flight while the current one is used (a 2-stage ring); rows at or
// past T are zero-filled, so no stale NaN enters a product. Every product
// is mma.sync.m16n8k16 (bf16 in, fp32 sums), and every logit tile comes from
// one routine (mma_tile::s_tile: the sum over D in the same order in the
// forward, in both passes, and in both backward kernels). The A operand is
// read from shared memory by ldmatrix at each 16-wide step (one load per
// eight products) rather than held in registers, which keeps the registers
// for the accumulators at D = 128.
//   forward: a block per (b, h, 64-row query tile) makes two passes over
//     the key tiles its rows can see (key_range): pass 1 reads K and takes
//     each row's maximum, pass 2 rebuilds the same logits bit for bit (the
//     scale is applied with __fmul_rn, so no FMA contraction can round a
//     logit differently), takes exp2 against the global maximum, sums the
//     row in fp32 and packs P to bf16 straight into A fragments for
//     O += P V (V read transposed by ldmatrix). Two passes cost a third more
//     products than one online-softmax pass, but round exactly the
//     probabilities the reference rounds. The epilogue divides by the row
//     sum and stores O through shared memory in 16-byte lines, plus the
//     (B, H, T, 2) fp32 stats (row maximum, row sum; kept apart because
//     log2(z) vanishes beside the finite NEG_INF of a fully hidden row).
//   backward, three launches:
//     1. delta = rowsum(do * o) per (b, h, row): the diagonal of dO O^T by
//        the same s_tile as dP, so dp - delta is exactly 0 where o is a
//        row of v (a row that sees one key), as in exact arithmetic;
//     2. dK/dV: a block per (b, kv head, 64-key tile) keeps K and V in
//        shared memory and walks the group's query heads and the query
//        tiles that reach its keys, Q, dO and their stats double-buffered.
//        It computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS16^T sit
//        in the A layout for dV += P^T dO and dK += dS16^T Q;
//     3. dQ: a block per (b, h, 64-row query tile) runs dQ += dS16 K over
//        its visible key tiles.
//   The mask is an interval of keys per row (Span), so a masked element
//   costs two compares; a tile that the mask leaves whole (tile_open)
//   skips even those. Divisions by the row sum are a correctly rounded
//   quotient from one reciprocal per row (div_rn).
// The Pallas kernel accumulates dK/dV by revisiting one output block over
// sequential grid steps; CUDA blocks run concurrently and in no order, so
// the FlashAttention-2 split replaces it.
//
// fp32 keeps the CUDA-core kernels below (flash_fwd_kernel and the rest,
// 64-row query tiles, 32-key tiles, FMAs from fp32 shared memory): fp32 on
// the tensor cores means TF32, whose 10-bit mantissa would break the 1e-5
// agreement with the plain version that the fp32 checks hold.
#include <math.h>

#include <type_traits>

#include "attn_mask.cuh"
#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using namespace attn_mask;

constexpr int BQ = 64, BKV = 32, kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RS = BQ / kWarps;  // score rows per thread (lane = key column)
// dst[j * pitch + d] = src[(r0 + j) * stride + d] for j < nrows (0 past n)
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int pitch, const T* src, long long stride,
                                          int r0, int nrows, int n) {
  for (int e = threadIdx.x; e < nrows * D; e += kThreads) {
    const int j = e / D, d = e % D, r = r0 + j;
    dst[j * pitch + d] = r < n ? to_f32(src[r * stride + d]) : 0.f;
  }
}

// acc[r] = A[row_r] . Bm[lane] over D, rows warp + kWarps * r (pitch D + 1)
template <int D>
__device__ __forceinline__ void dot_rows(const float* A, const float* Bm, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < RS; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float bd = Bm[lane * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < RS; ++r) acc[r] = fmaf(A[(warp + kWarps * r) * (D + 1) + d], bd, acc[r]);
  }
}

template <int D>
constexpr size_t fwd_smem() {
  return (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ stats, int H, int group, int Tn,
                 float scale_log2e, const int* __restrict__ lengths, int causal, int window,
                 int lb) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ  x (D+1)
  float* Ks = Qs + BQ * (D + 1);    // BKV x (D+1)
  float* Vs = Ks + BKV * (D + 1);   // BKV x D
  float* Ps = Vs + BKV * D;         // BQ  x (BKV+1) rounded probabilities
  float* Zs = Ps + BQ * (BKV + 1);  // BQ  row sums

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group, hk = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const T* qb = q + (long long)b * Tn * qst + (long long)h * D;
  const T* kb = k + (long long)b * Tn * kst + (long long)hk * D;
  const T* vb = v + (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};
  const Range rg = key_range(mk, q0, min(q0 + BQ, Tn));
  const int lo = rg.full ? 0 : rg.lo, hi = rg.full ? Tn : rg.hi;

  load_rows<T, D>(Qs, D + 1, qb, qst, q0, BQ, Tn);

  auto scores = [&](int k0, float* s) {
    dot_rows<D>(Qs, Ks, s);
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int row = q0 + warp + kWarps * r;
      // keys past the sequence do not exist: -inf gives them probability 0
      s[r] = col >= Tn ? -INFINITY : (mk.hidden(row, col) ? kNegInf : s[r] * scale_log2e);
    }
  };

  // pass 1: row maxima
  float m[RS], s[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) m[r] = -INFINITY;
  for (int k0 = lo; k0 < hi; k0 += BKV) {
    __syncthreads();
    load_rows<T, D>(Ks, D + 1, kb, kst, k0, BKV, Tn);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < RS; ++r) m[r] = fmaxf(m[r], warp_max(s[r]));
  }

  // pass 2: probabilities, row sums and P.V
  constexpr int ROW_STEP = kThreads / D;
  constexpr int RO = BQ / ROW_STEP;
  const int od = tid % D, orow = tid / D;
  float acc[RO], z[RS];
#pragma unroll
  for (int r = 0; r < RO; ++r) acc[r] = 0.f;
#pragma unroll
  for (int r = 0; r < RS; ++r) z[r] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += BKV) {
    __syncthreads();
    load_rows<T, D>(Ks, D + 1, kb, kst, k0, BKV, Tn);
    load_rows<T, D>(Vs, D, vb, kst, k0, BKV, Tn);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const float e = exp2f(s[r] - m[r]);
      z[r] += e;
      Ps[(warp + kWarps * r) * (BKV + 1) + lane] = round_to<T>(e);
    }
    __syncthreads();
    const int jmax = min(BKV, Tn - k0);
    for (int j = 0; j < jmax; ++j) {
      const float vv = Vs[j * D + od];
#pragma unroll
      for (int r = 0; r < RO; ++r)
        acc[r] = fmaf(Ps[(orow + ROW_STEP * r) * (BKV + 1) + j], vv, acc[r]);
    }
  }

  float* st = stats + ((long long)b * H + h) * Tn * 2;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const float zt = warp_sum(z[r]);
    const int i = warp + kWarps * r, t = q0 + i;
    if (lane == 0) {
      Zs[i] = zt;
      if (t < Tn) {
        st[2 * t] = m[r];
        st[2 * t + 1] = zt;
      }
    }
  }
  __syncthreads();
  T* ob = o + (long long)b * Tn * qst + (long long)h * D;
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int i = orow + ROW_STEP * r, t = q0 + i;
    if (t < Tn) ob[t * qst + od] = from_f32<T>(acc[r] / Zs[i]);
  }
}

// delta[b, h, t] = sum_d do[b, t, h, d] * o[b, t, h, d] in fp32; a warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
                   int H, int Tn, int D, long long rows) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* ob = o + row * D;
  const T* db = dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(db[d]), to_f32(ob[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {  // row = (b * T + t) * H + h
    const long long h = row % H, bt = row / H, t = bt % Tn, b = bt / Tn;
    delta[(b * H + h) * Tn + t] = acc;
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return (2 * BQ * (D + 1) + 2 * BKV * (D + 1) + 2 * BQ * (BKV + 1) + 3 * BQ) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem() {
  return (2 * BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * (BKV + 1) + 3 * BQ) * sizeof(float);
}

// Row statistics of query tile [q0, q0 + BQ) of (b, h): max, sum, delta.
__device__ __forceinline__ void load_stats(float* Ms, float* Zs, float* Dl, const float* stats,
                                           const float* delta, long long bh, int q0, int Tn) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int t = q0 + i;
    const bool ok = t < Tn;
    Ms[i] = ok ? stats[(bh * Tn + t) * 2] : 0.f;
    Zs[i] = ok ? stats[(bh * Tn + t) * 2 + 1] : 1.f;
    Dl[i] = ok ? delta[bh * Tn + t] : 0.f;
  }
}

// p and ds16 for the tile pair (rows q0 + warp + kWarps r, key k0 + lane)
// from the scores s (q.k) and dp (do.v): p = exp2(s' - m) / z with s' the
// scaled logit or NEG_INF where hidden; ds = p (dp - delta), 0 where hidden.
template <typename T>
__device__ __forceinline__ void probs_and_ds(const Mask& mk, int q0, int k0, int Tn,
                                             float scale_log2e, float scale, const float* s,
                                             const float* dp, const float* Ms, const float* Zs,
                                             const float* Dl, float* Ps, float* dSs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = k0 + lane;
#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const int i = warp + kWarps * r, row = q0 + i;
    const bool exists = row < Tn && col < Tn;
    const bool hid = mk.hidden(row, col);
    const float sl = hid ? kNegInf : s[r] * scale_log2e;
    const float p = exists ? exp2f(sl - Ms[i]) / Zs[i] : 0.f;
    const float ds = (exists && !hid) ? p * (dp[r] - Dl[i]) : 0.f;
    if (Ps) Ps[i * (BKV + 1) + lane] = round_to<T>(p);
    dSs[i * (BKV + 1) + lane] = round_to<T>(ds * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ stats,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
                  int group, int Tn, float scale_log2e, float scale,
                  const int* __restrict__ lengths, int causal, int window, int lb) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // BQ  x (D+1)
  float* dOs = Qs + BQ * (D + 1);     // BQ  x (D+1)
  float* Ks = dOs + BQ * (D + 1);     // BKV x (D+1)
  float* Vs = Ks + BKV * (D + 1);     // BKV x (D+1)
  float* Ps = Vs + BKV * (D + 1);     // BQ  x (BKV+1) p rounded to T
  float* dSs = Ps + BQ * (BKV + 1);   // BQ  x (BKV+1) ds16
  float* Ms = dSs + BQ * (BKV + 1);   // BQ
  float* Zs = Ms + BQ;                // BQ
  float* Dl = Zs + BQ;                // BQ

  const int k0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group;
  const int tid = threadIdx.x;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const long long koff = (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};

  load_rows<T, D>(Ks, D + 1, k + koff, kst, k0, BKV, Tn);
  load_rows<T, D>(Vs, D + 1, v + koff, kst, k0, BKV, Tn);

  constexpr int ROW_STEP = kThreads / D;
  constexpr int RK = BKV / ROW_STEP;
  const int od = tid % D, orow = tid / D;
  float dk_acc[RK], dv_acc[RK];
#pragma unroll
  for (int r = 0; r < RK; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long qoff = (long long)b * Tn * qst + (long long)h * D;
    for (int q0 = 0; q0 < Tn; q0 += BQ) {
      const Range rg = key_range(mk, q0, min(q0 + BQ, Tn));
      if (!rg.full && (k0 >= rg.hi || k0 + BKV <= rg.lo)) continue;
      __syncthreads();
      load_rows<T, D>(Qs, D + 1, q + qoff, qst, q0, BQ, Tn);
      load_rows<T, D>(dOs, D + 1, dout + qoff, qst, q0, BQ, Tn);
      load_stats(Ms, Zs, Dl, stats, delta, (long long)b * H + h, q0, Tn);
      __syncthreads();
      float s[RS], dp[RS];
      dot_rows<D>(Qs, Ks, s);
      dot_rows<D>(dOs, Vs, dp);
      probs_and_ds<T>(mk, q0, k0, Tn, scale_log2e, scale, s, dp, Ms, Zs, Dl, Ps, dSs);
      __syncthreads();
      const int imax = min(BQ, Tn - q0);
      for (int i = 0; i < imax; ++i) {
        const float dov = dOs[i * (D + 1) + od], qv = Qs[i * (D + 1) + od];
#pragma unroll
        for (int r = 0; r < RK; ++r) {
          const int j = orow + ROW_STEP * r;
          dv_acc[r] = fmaf(Ps[i * (BKV + 1) + j], dov, dv_acc[r]);
          dk_acc[r] = fmaf(dSs[i * (BKV + 1) + j], qv, dk_acc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int t = k0 + orow + ROW_STEP * r;
    if (t < Tn) {
      dk[koff + t * kst + od] = from_f32<T>(dk_acc[r]);
      dv[koff + t * kst + od] = from_f32<T>(dv_acc[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ stats,
                const float* __restrict__ delta, T* __restrict__ dq, int H, int group, int Tn,
                float scale_log2e, float scale, const int* __restrict__ lengths, int causal,
                int window, int lb) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // BQ  x (D+1)
  float* dOs = Qs + BQ * (D + 1);     // BQ  x (D+1)
  float* Ks = dOs + BQ * (D + 1);     // BKV x (D+1)
  float* Vs = Ks + BKV * (D + 1);     // BKV x (D+1)
  float* dSs = Vs + BKV * (D + 1);    // BQ  x (BKV+1) ds16
  float* Ms = dSs + BQ * (BKV + 1);   // BQ
  float* Zs = Ms + BQ;                // BQ
  float* Dl = Zs + BQ;                // BQ

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group, hk = h / group;
  const int tid = threadIdx.x;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const long long qoff = (long long)b * Tn * qst + (long long)h * D;
  const long long koff = (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};
  // a row that sees no key gets no gradient (ds is 0 where hidden), so only
  // the keys some row can see are visited
  const Range rg = key_range(mk, q0, min(q0 + BQ, Tn));

  load_rows<T, D>(Qs, D + 1, q + qoff, qst, q0, BQ, Tn);
  load_rows<T, D>(dOs, D + 1, dout + qoff, qst, q0, BQ, Tn);
  load_stats(Ms, Zs, Dl, stats, delta, (long long)b * H + h, q0, Tn);

  constexpr int ROW_STEP = kThreads / D;
  constexpr int RQ = BQ / ROW_STEP;
  const int od = tid % D, orow = tid / D;
  float acc[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) acc[r] = 0.f;

  for (int k0 = rg.lo; k0 < rg.hi; k0 += BKV) {
    __syncthreads();
    load_rows<T, D>(Ks, D + 1, k + koff, kst, k0, BKV, Tn);
    load_rows<T, D>(Vs, D + 1, v + koff, kst, k0, BKV, Tn);
    __syncthreads();
    float s[RS], dp[RS];
    dot_rows<D>(Qs, Ks, s);
    dot_rows<D>(dOs, Vs, dp);
    probs_and_ds<T>(mk, q0, k0, Tn, scale_log2e, scale, s, dp, Ms, Zs, Dl, nullptr, dSs);
    __syncthreads();
    const int jmax = min(BKV, Tn - k0);
    for (int j = 0; j < jmax; ++j) {
      const float kv = Ks[j * (D + 1) + od];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        acc[r] = fmaf(dSs[(orow + ROW_STEP * r) * (BKV + 1) + j], kv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int t = q0 + orow + ROW_STEP * r;
    if (t < Tn) dq[qoff + t * qst + od] = from_f32<T>(acc[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (mma_tile.cuh)
// ---------------------------------------------------------------------------

namespace mt = mma_tile;
using mt::bf16;

constexpr int TB = 64;             // query rows and keys per tile
constexpr int kMmaThreads = 128;   // 4 warps of 16 rows
constexpr int kStatsBytes = 2 * TB * 3 * (int)sizeof(float);  // 2 stages of (m, z, delta)

template <int D>
constexpr size_t tile_bytes() {
  return mt::Tile<D>::template bytes<TB>();
}

// e / z rounded to nearest from r = 1/z rounded to nearest (Markstein: the
// FMA remainder is exact, so the corrected quotient is the correctly rounded
// one for normal values), so a row's z costs one reciprocal, not one
// division per element
__device__ __forceinline__ float div_rn(float e, float z, float r) {
  const float q = e * r;
  return fmaf(fmaf(-q, z, e), r, q);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ stats,
                     int H, int group, int Tn, float scale_log2e, const int* __restrict__ lengths,
                     int causal, int window, int lb) {
  constexpr int TILE = TB * mt::Tile<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages

  const int q0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const bf16* qb = q + (long long)b * Tn * qst + (long long)h * D;
  const bf16* kb = k + (long long)b * Tn * kst + (long long)hk * D;
  const bf16* vb = v + (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};
  const Range rg = key_range(mk, q0, min(q0 + TB, Tn));
  const int lo = rg.full ? 0 : rg.lo, hi = rg.full ? Tn : rg.hi;
  const int ntiles = hi > lo ? (hi - lo + TB - 1) / TB : 0;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const Span sp[2] = {row_span(mk, r0 + mt::acc_row(0)), row_span(mk, r0 + mt::acc_row(2))};

  // the logits of key tile k0 in this warp's rows from their products s;
  // keys past T get -inf (rows past T are never stored). Three paths: a
  // tile the mask leaves whole, the last tile of an unmasked row (keys past
  // T only), and a masked tile.
  auto scale_mask = [&](float (&s)[8][4], int k0) {
    const bool open = tile_open<TB, TB>(mk, q0, k0);
    const int past = Tn - k0 - 2 * (lane & 3);  // offsets 8 n + c from here are past T
    if (open && keys_in_range<TB>(mk, k0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale_log2e);
    } else if (open) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = 8 * n + (e & 1) >= past ? -INFINITY : __fmul_rn(s[n][e], scale_log2e);
    } else {
      const Local l[2] = {local(sp[0], k0), local(sp[1], k0)};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * n + (e & 1);
          s[n][e] = x >= past ? -INFINITY : logit(l[e >> 1].hides(x), s[n][e], scale_log2e);
        }
    }
  };

  // pass 1: row maxima (K only)
  mt::load_tile<D, TB, kMmaThreads>(Qs, qb, qst, q0, Tn);
  if (ntiles > 0) mt::load_tile<D, TB, kMmaThreads>(Ks, kb, kst, lo, Tn);
  mt::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * TB;
    if (it + 1 < ntiles)
      mt::load_tile<D, TB, kMmaThreads>(Ks + ((it + 1) & 1) * TILE, kb, kst, k0 + TB, Tn);
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    mt::s_tile<D>(s, Qs, 16 * warp, Ks + (it & 1) * TILE);
    scale_mask(s, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[n][e]);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the four lanes of a quad share a row
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }

  // pass 2: the same logits, exp2 against the global maximum, row sums, P.V
  if (ntiles > 0) {
    mt::load_tile<D, TB, kMmaThreads>(Ks, kb, kst, lo, Tn);
    mt::load_tile<D, TB, kMmaThreads>(Vs, vb, kst, lo, Tn);
  }
  mt::cp_async_commit();
  float acc[D / 8][4] = {};
  float z[2] = {0.f, 0.f};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * TB, st = it & 1;
    if (it + 1 < ntiles) {
      mt::load_tile<D, TB, kMmaThreads>(Ks + (st ^ 1) * TILE, kb, kst, k0 + TB, Tn);
      mt::load_tile<D, TB, kMmaThreads>(Vs + (st ^ 1) * TILE, vb, kst, k0 + TB, Tn);
    }
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    mt::s_tile<D>(s, Qs, 16 * warp, Ks + st * TILE);
    scale_mask(s, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ex = exp2f(s[n][e] - m[e >> 1]);
        z[e >> 1] += ex;
        s[n][e] = ex;
      }
    uint32_t p[4][4];
    mt::pack_a(p, s);
    mt::pv_tile<D>(acc, p, Vs + st * TILE);
    __syncthreads();
  }
  mt::cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed before Qs is reused
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
  }

  if ((lane & 3) == 0) {
    float* st = stats + ((long long)b * H + h) * Tn * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = r0 + (lane >> 2) + 8 * i;
      if (t < Tn) {
        st[2 * t] = m[i];
        st[2 * t + 1] = z[i];
      }
    }
  }
  // this warp's 16 rows of Qs were read by this warp alone
  mt::store_rows<D>(acc, z, Qs + 16 * warp * mt::Tile<D>::kPitch,
                    o + (long long)b * Tn * qst + (long long)h * D, qst, r0, Tn);
}

// delta[b, h, t] = sum_d do[b, t, h, d] * o[b, t, h, d] in fp32, a block per
// (b, h, 64-row tile): the diagonal of dO O^T, by s_tile. The kernels'
// dp = do . v comes from the same routine, so where o equals a row of v (a
// row that sees one key) dp - delta is exactly 0, as in exact arithmetic.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_delta_mma_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Tn) {
  constexpr int TILE = TB * mt::Tile<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = dOs + TILE;
  const int q0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long st = (long long)H * D, off = (long long)b * Tn * st + (long long)h * D;
  mt::load_tile<D, TB, kMmaThreads>(dOs, dout + off, st, q0, Tn);
  mt::load_tile<D, TB, kMmaThreads>(Os, o + off, st, q0, Tn);
  mt::cp_async_commit();
  mt::cp_async_wait<0>();
  __syncthreads();
  float acc[2][4];  // rows and columns 16 warp .. 16 warp + 15
  mt::s_tile<D, 1>(acc, dOs, 16 * warp, Os + 16 * warp * mt::Tile<D>::kPitch);
  // element (r, r) sits in lane g = r % 8, t = g / 2, at [r / 8][2 (r / 8) + g % 2]
  const int g = lane >> 2;
  if ((lane & 3) == (g >> 1)) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = q0 + 16 * warp + g + 8 * i;
      if (t < Tn) delta[((long long)b * H + h) * Tn + t] = (g & 1) ? acc[i][2 * i + 1] : acc[i][2 * i];
    }
  }
}

template <int D>
constexpr size_t dkdv_mma_smem() {
  return 6 * tile_bytes<D>() + kStatsBytes;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ stats, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int group, int Tn,
                      float scale_log2e, float scale, const int* __restrict__ lengths, int causal,
                      int window, int lb) {
  constexpr int P = mt::Tile<D>::kPitch, TILE = TB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;         // 2 stages
  bf16* dOs = Qs + 2 * TILE;    // 2 stages
  float* Ss = reinterpret_cast<float*>(dOs + 2 * TILE);  // 2 stages of TB x (m, z)
  float* Dl = Ss + 2 * TB * 2;                           // 2 stages of TB deltas

  const int k0 = blockIdx.x * TB, hk = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group, warp = threadIdx.x >> 5;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const long long koff = (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};
  const int kr0 = k0 + 16 * warp;  // this warp's first key
  const int ntq = (Tn + TB - 1) / TB, total = group * ntq;
  // the query rows that see each of this lane's two keys (none past T)
  Span ks[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = kr0 + mt::acc_row(2 * i);
    ks[i] = col < Tn ? key_span(mk, col) : Span{0, 0};
    ks[i].hi = min(ks[i].hi, Tn);
  }

  // item i = (query head hk * group + i / ntq, query tile i % ntq); the
  // tiles some of whose rows see a key of this block, or that hold a row
  // that sees none (it spreads p over every key)
  auto next = [&](int i) {
    for (; i < total; ++i) {
      const int q0 = (i % ntq) * TB;
      const Range rg = key_range(mk, q0, min(q0 + TB, Tn));
      if (rg.full || (k0 < rg.hi && k0 + TB > rg.lo)) break;
    }
    return i;
  };
  auto fetch = [&](int i, int stg) {
    const int h = hk * group + i / ntq, q0 = (i % ntq) * TB;
    const long long qoff = (long long)b * Tn * qst + (long long)h * D, bh = (long long)b * H + h;
    mt::load_tile<D, TB, kMmaThreads>(Qs + stg * TILE, q + qoff, qst, q0, Tn);
    mt::load_tile<D, TB, kMmaThreads>(dOs + stg * TILE, dout + qoff, qst, q0, Tn);
    for (int j = threadIdx.x; j < TB; j += kMmaThreads) {
      const int t = q0 + j;
      if (t < Tn) {
        mt::cp_async_small<8>(Ss + (stg * TB + j) * 2, stats + (bh * Tn + t) * 2, true);
        mt::cp_async_small<4>(Dl + stg * TB + j, delta + bh * Tn + t, true);
      } else {  // a row past T: p = exp2(s - inf) = 0, so ds = 0 too
        Ss[(stg * TB + j) * 2] = INFINITY;
        Ss[(stg * TB + j) * 2 + 1] = 1.f;
        Dl[stg * TB + j] = 0.f;
      }
    }
  };

  mt::load_tile<D, TB, kMmaThreads>(Ks, k + koff, kst, k0, Tn);
  mt::load_tile<D, TB, kMmaThreads>(Vs, v + koff, kst, k0, Tn);
  int i = next(0);
  if (i < total) fetch(i, 0);
  mt::cp_async_commit();
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int it = 0; i < total; ++it) {
    const int stg = it & 1, inext = next(i + 1);
    if (inext < total) fetch(inext, stg ^ 1);
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    const int q0 = (i % ntq) * TB;
    const bf16* Qt = Qs + stg * TILE;
    const bf16* dOt = dOs + stg * TILE;
    const float* St = Ss + stg * TB * 2;
    const float* Dt = Dl + stg * TB;
    // rows past T give p = 0 (their stats); keys past T fill rows of the
    // accumulators that are never stored. One item, with or without the mask:
    auto item = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      Local l[2] = {};
      if constexpr (kMasked) l[0] = local(ks[0], q0), l[1] = local(ks[1], q0);
      // P^T: rows are this warp's keys, columns the tile's queries; each
      // query's stats serve both of this lane's keys
      float s[8][4];
      mt::s_tile<D>(s, Ks, 16 * warp, Qt);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = mt::acc_col(n, c);
          const float m = St[2 * j], z = St[2 * j + 1], r = __frcp_rn(z);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool hid = kMasked && l[i].hides(8 * n + c);
            s[n][2 * i + c] = div_rn(exp2f(logit(hid, s[n][2 * i + c], scale_log2e) - m), z, r);
          }
        }
      uint32_t pa[4][4];
      mt::pack_a(pa, s);
      mt::pv_tile<D>(dv_acc, pa, dOt);  // dV += P^T dO

      float dp[8][4];
      mt::s_tile<D>(dp, Vs, 16 * warp, dOt);  // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float dl = Dt[mt::acc_col(n, c)];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            const float ds = s[n][e] * (dp[n][e] - dl) * scale;
            dp[n][e] = kMasked && l[i].hides(8 * n + c) ? 0.f : ds;
          }
        }
      mt::pack_a(pa, dp);
      mt::pv_tile<D>(dk_acc, pa, Qt);  // dK += dS16^T Q
    };
    if (tile_open<TB, TB>(mk, q0, k0))
      item(std::false_type{});
    else
      item(std::true_type{});
    __syncthreads();
    i = inext;
  }
  mt::cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 rows of Ks and Vs were read by this warp alone
  const float one[2] = {1.f, 1.f};
  mt::store_rows<D>(dv_acc, one, Vs + 16 * warp * P, dv + koff, kst, kr0, Tn);
  mt::store_rows<D>(dk_acc, one, Ks + 16 * warp * P, dk + koff, kst, kr0, Tn);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ stats, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int group, int Tn, float scale_log2e,
                    float scale, const int* __restrict__ lengths, int causal, int window, int lb) {
  constexpr int P = mt::Tile<D>::kPitch, TILE = TB * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;     // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages

  const int q0 = blockIdx.x * TB, h = blockIdx.y, b = blockIdx.z;
  const int Hkv = H / group, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qst = (long long)H * D, kst = (long long)Hkv * D;
  const long long qoff = (long long)b * Tn * qst + (long long)h * D;
  const bf16* kb = k + (long long)b * Tn * kst + (long long)hk * D;
  const bf16* vb = v + (long long)b * Tn * kst + (long long)hk * D;
  const Mask mk{Tn, lengths ? lengths[b] : Tn, causal, window, lb};
  // a row that sees no key gets no gradient (ds is 0 where hidden), so only
  // the keys some row can see are visited
  const Range rg = key_range(mk, q0, min(q0 + TB, Tn));
  const int ntiles = rg.hi > rg.lo ? (rg.hi - rg.lo + TB - 1) / TB : 0;
  const int r0 = q0 + 16 * warp;

  mt::load_tile<D, TB, kMmaThreads>(Qs, q + qoff, qst, q0, Tn);
  mt::load_tile<D, TB, kMmaThreads>(dOs, dout + qoff, qst, q0, Tn);
  if (ntiles > 0) {
    mt::load_tile<D, TB, kMmaThreads>(Ks, kb, kst, rg.lo, Tn);
    mt::load_tile<D, TB, kMmaThreads>(Vs, vb, kst, rg.lo, Tn);
  }
  mt::cp_async_commit();
  float rm[2], rz[2], rd[2], rr[2];  // max, sum, delta, 1 / sum of this lane's two rows
  Span sp[2];                 // the keys each of them sees (none past T)
  bool ok[2];
  const long long bh = (long long)b * H + h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + (lane >> 2) + 8 * i;
    ok[i] = t < Tn;
    rm[i] = ok[i] ? stats[(bh * Tn + t) * 2] : 0.f;
    rz[i] = ok[i] ? stats[(bh * Tn + t) * 2 + 1] : 1.f;
    rd[i] = ok[i] ? delta[bh * Tn + t] : 0.f;
    rr[i] = __frcp_rn(rz[i]);
    sp[i] = ok[i] ? row_span(mk, t) : Span{0, 0};
    sp[i].hi = min(sp[i].hi, Tn);
  }

  float acc[D / 8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = rg.lo + it * TB, st = it & 1;
    if (it + 1 < ntiles) {
      mt::load_tile<D, TB, kMmaThreads>(Ks + (st ^ 1) * TILE, kb, kst, k0 + TB, Tn);
      mt::load_tile<D, TB, kMmaThreads>(Vs + (st ^ 1) * TILE, vb, kst, k0 + TB, Tn);
    }
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + st * TILE;
    // a row past T has q = do = 0, stats (0, 1, 0): p = 1, dp = 0, ds = 0;
    // keys past T must be hidden (p could overflow against them)
    auto tile = [&](auto masked) {
      constexpr bool kMasked = decltype(masked)::value;
      Local l[2] = {};
      if constexpr (kMasked) l[0] = local(sp[0], k0), l[1] = local(sp[1], k0);
      float s[8][4], dp[8][4];
      mt::s_tile<D>(s, Qs, 16 * warp, Kt);
      mt::s_tile<D>(dp, dOs, 16 * warp, Vs + st * TILE);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = div_rn(exp2f(__fmul_rn(s[n][e], scale_log2e) - rm[i]), rz[i], rr[i]);
          const float ds = p * (dp[n][e] - rd[i]) * scale;
          s[n][e] = kMasked && l[i].hides(8 * n + (e & 1)) ? 0.f : ds;
        }
      uint32_t pa[4][4];
      mt::pack_a(pa, s);
      mt::pv_tile<D>(acc, pa, Kt);  // dQ += dS16 K
    };
    if (tile_open<TB, TB>(mk, q0, k0) && keys_in_range<TB>(mk, k0))
      tile(std::false_type{});
    else
      tile(std::true_type{});
    __syncthreads();
  }
  // with no key tile the loop never waited: every thread's copies must land
  // before Qs is reused
  mt::cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 rows of Qs were read by this warp alone
  const float one[2] = {1.f, 1.f};
  mt::store_rows<D>(acc, one, Qs + 16 * warp * P, dq + qoff, qst, r0, Tn);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lengths;
  void *out, *stats, *delta, *dq, *dk, *dv;
  int B, H, group, T, causal, window, lb;
  float scale_log2e, scale;
  cudaStream_t stream;
};

template <typename T, int D>
int forward(const Args& a) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out), static_cast<float*>(a.stats), a.H, a.group, a.T, a.scale_log2e,
      static_cast<const int*>(a.lengths), a.causal, a.window, a.lb);
  return cudaGetLastError();
}

template <typename T, int D>
int backward(const Args& a) {
  const long long rows = (long long)a.B * a.T * a.H;
  flash_delta_kernel<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), static_cast<float*>(a.delta),
      a.H, a.T, D, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  constexpr size_t smem_kv = dkdv_smem<D>();
  if ((e = allow_smem(flash_dkdv_kernel<T, D>, smem_kv)) != cudaSuccess) return e;
  dim3 grid_kv((a.T + BKV - 1) / BKV, a.H / a.group, a.B);
  flash_dkdv_kernel<T, D><<<grid_kv, kThreads, smem_kv, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.stats),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.group, a.T, a.scale_log2e, a.scale, static_cast<const int*>(a.lengths), a.causal,
      a.window, a.lb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t smem_q = dq_smem<D>();
  if ((e = allow_smem(flash_dq_kernel<T, D>, smem_q)) != cudaSuccess) return e;
  dim3 grid_q((a.T + BQ - 1) / BQ, a.H, a.B);
  flash_dq_kernel<T, D><<<grid_q, kThreads, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.stats),
      static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.H, a.group, a.T,
      a.scale_log2e, a.scale, static_cast<const int*>(a.lengths), a.causal, a.window, a.lb);
  return cudaGetLastError();
}

template <int D>
int forward_mma(const Args& a) {
  constexpr size_t smem = 5 * tile_bytes<D>();
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.T + TB - 1) / TB, a.H, a.B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.out), static_cast<float*>(a.stats),
      a.H, a.group, a.T, a.scale_log2e, static_cast<const int*>(a.lengths), a.causal, a.window,
      a.lb);
  return cudaGetLastError();
}

template <int D>
int backward_mma(const Args& a) {
  dim3 grid((a.T + TB - 1) / TB, a.H, a.B);
  constexpr size_t smem_d = 2 * tile_bytes<D>();
  cudaError_t e = allow_smem(flash_delta_mma_kernel<D>, smem_d);
  if (e != cudaSuccess) return e;
  flash_delta_mma_kernel<D><<<grid, kMmaThreads, smem_d, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<float*>(a.delta), a.H, a.T);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t smem_kv = dkdv_mma_smem<D>();
  if ((e = allow_smem(flash_dkdv_mma_kernel<D>, smem_kv)) != cudaSuccess) return e;
  dim3 grid_kv((a.T + TB - 1) / TB, a.H / a.group, a.B);
  flash_dkdv_mma_kernel<D><<<grid_kv, kMmaThreads, smem_kv, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.stats), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.group, a.T, a.scale_log2e,
      a.scale, static_cast<const int*>(a.lengths), a.causal, a.window, a.lb);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  constexpr size_t smem_q = 6 * tile_bytes<D>();
  if ((e = allow_smem(flash_dq_mma_kernel<D>, smem_q)) != cudaSuccess) return e;
  flash_dq_mma_kernel<D><<<grid, kMmaThreads, smem_q, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.stats), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.dq), a.H, a.group, a.T, a.scale_log2e, a.scale,
      static_cast<const int*>(a.lengths), a.causal, a.window, a.lb);
  return cudaGetLastError();
}

// cp.async and the 16-byte stores need every bf16 operand 16-byte aligned
bool aligned16(const Args& a, bool bwd) {
  const void* ptrs[] = {a.q, a.k, a.v, bwd ? a.o : a.out, bwd ? a.dout : nullptr,
                        bwd ? a.dq : nullptr, bwd ? a.dk : nullptr, bwd ? a.dv : nullptr};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// fp32 takes the CUDA-core kernels, bf16 the tensor-core ones
int dispatch(bool bwd, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.group <= 0 || a.H % a.group || a.T <= 0)
    return cudaErrorInvalidValue;
  if (dtype == UV_F32 && D == 64) return bwd ? backward<float, 64>(a) : forward<float, 64>(a);
  if (dtype == UV_F32 && D == 128) return bwd ? backward<float, 128>(a) : forward<float, 128>(a);
  if (dtype == UV_BF16 && !aligned16(a, bwd)) return cudaErrorMisalignedAddress;
  if (dtype == UV_BF16 && D == 64) return bwd ? backward_mma<64>(a) : forward_mma<64>(a);
  if (dtype == UV_BF16 && D == 128) return bwd ? backward_mma<128>(a) : forward_mma<128>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Forward. q, out (B, T, H, D); k, v (B, T, H / group, D), contiguous, one
// dtype; stats (B, H, T, 2) fp32 receives each row's maximum and sum;
// lengths (B,) int32 or null.
UV_EXPORT int uv_flash_attention(const void* q, const void* k, const void* v, void* out,
                                 void* stats, const void* lengths, int B, int H, int group, int T,
                                 int D, float scale_log2e, int causal, int window,
                                 int latency_block, int dtype, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out = out; a.stats = stats; a.lengths = lengths;
  a.B = B; a.H = H; a.group = group; a.T = T;
  a.causal = causal; a.window = window; a.lb = latency_block;
  a.scale_log2e = scale_log2e;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(false, D, dtype, a);
}

// Backward: three launches (delta, dK/dV, dQ). o is the forward's output,
// dout its gradient in q's dtype; delta (B, H, T) fp32 is scratch; dq, dk,
// dv take q's and k's shapes.
UV_EXPORT int uv_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* stats, void* delta, void* dq,
                                     void* dk, void* dv, const void* lengths, int B, int H,
                                     int group, int T, int D, float scale_log2e, float scale,
                                     int causal, int window, int latency_block, int dtype,
                                     void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout; a.lengths = lengths;
  a.stats = const_cast<void*>(stats); a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.group = group; a.T = T;
  a.causal = causal; a.window = window; a.lb = latency_block;
  a.scale_log2e = scale_log2e; a.scale = scale;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(true, D, dtype, a);
}

UV_DEFINE_ERROR_STRING(uv_flash_attention)
