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
// exp2 against the row's global maximum, probabilities rounded to the value
// dtype before the PV product, fp32 accumulation, division by the row sum
// last. A row with no visible key (lengths[b] == 0, or a padding row past
// length + window) therefore averages v over all T keys, as the Pallas
// kernel does, and its output is finite. The backward keeps the Pallas
// rounding points: dv += p.astype(T)^T do; dp = do v^T in fp32;
// ds = p (dp - rowsum(do o)), zero where hidden; ds16 = (ds * scale)
// rounded to T; dq = ds16 k and dk += ds16^T q, fp32-accumulated, cast to T
// at the end.
//
// Bound on the card: operations at the training shapes (decoder
// (8, 190, 32, 64) causal, encoder (8, 500, 12, 64); each (q, k) pair costs
// 4 D flops forward and 8-10 D backward against 2 D bytes of its tiles).
// Design: no (T, T) logits tensor reaches device memory. Forward: a block
// owns 64 query rows of one (b, h) in shared memory and streams 32-key
// tiles of K and V; like csrc/attention.cu it makes two passes over the
// keys (row maxima, then exp2/row sums/P.V) so that it rounds exactly the
// probabilities the reference rounds. It stores the fp32 row maximum and
// row sum (B, H, T, 2) as a residual, so the backward rebuilds p = exp2(s -
// m) / z without reducing whole rows again (the maximum and the sum are
// kept apart because log2(z) vanishes beside the finite NEG_INF of a fully
// hidden row). Each block visits only the key tiles some row of its tile
// can see (all of them when a row of the tile sees none).
// Backward: the Pallas kernel accumulates dK/dV by revisiting one output
// block over sequential grid steps; CUDA blocks run concurrently and in no
// order, so the FlashAttention-2 split is used instead, with no atomics and
// results that do not change from run to run. Three launches per backward:
//   1. delta = rowsum(do * o) per (b, h, row);
//   2. dK/dV: a block per (b, kv head, 32-key tile) loops over the group's
//      query heads and the 64-row query tiles that reach its keys and keeps
//      dK and dV in fp32 registers;
//   3. dQ: a block per (b, h, 64-row query tile) loops over the key tiles
//      its rows can see.
// CUDA-core FMAs from fp32 shared memory; no tensor cores yet.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 32, kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RS = BQ / kWarps;  // score rows per thread (lane = key column)
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // finite mask value

struct Mask {
  int S, len, causal, window, lb;
  __device__ bool hidden(int row, int col) const {
    return col >= len || (causal && (col > row || (window > 0 && row - col >= window))) ||
           (lb > 0 && col / lb > row / lb);
  }
};

// Keys [lo, hi) hold every key that some row of [q0, q1) can see; `full`
// says some row of it sees none (it then averages over all S keys).
struct Range {
  int lo, hi;
  bool full;
};

__device__ __forceinline__ Range key_range(const Mask& m, int q0, int q1) {
  const int last = q1 - 1;
  Range r{0, min(m.S, m.len), false};
  if (m.causal) {
    r.hi = min(r.hi, last + 1);
    if (m.window > 0) r.lo = max(0, q0 - m.window + 1);
  }
  if (m.lb > 0) r.hi = min(r.hi, (last / m.lb + 1) * m.lb);
  r.full = m.len <= 0 || (m.causal && m.window > 0 && last - (m.len - 1) >= m.window);
  return r;
}

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

int dispatch(bool bwd, int D, int dtype, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.group <= 0 || a.H % a.group || a.T <= 0)
    return cudaErrorInvalidValue;
  if (dtype == UV_F32 && D == 64) return bwd ? backward<float, 64>(a) : forward<float, 64>(a);
  if (dtype == UV_F32 && D == 128) return bwd ? backward<float, 128>(a) : forward<float, 128>(a);
  if (dtype == UV_BF16 && D == 64)
    return bwd ? backward<__nv_bfloat16, 64>(a) : forward<__nv_bfloat16, 64>(a);
  if (dtype == UV_BF16 && D == 128)
    return bwd ? backward<__nv_bfloat16, 128>(a) : forward<__nv_bfloat16, 128>(a);
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
