// The fp32 attention kernel of attention.cu and encoder_attn_probe.cu, on
// the CUDA cores (bf16 runs on the tensor cores: attention_mma.cuh).
// fp32 on the tensor cores would be TF32, whose 10-bit mantissa would break
// the 1e-5 agreement with the plain version that the fp32 checks hold.
// Numerics and masks as attention.cu's header. Design: a block owns 64
// query rows of one (b, h) and keeps them in fp32 shared memory; K/V stream
// through shared memory in 32-key tiles; two passes over K (the row maxima,
// then exp2(s - m), P rounded to the value dtype, P.V in registers), so the
// probabilities round against the global row maximum; FMAs throughout.
// kExpBf16 selects the probes' bf16 exponent: exp2 of s - m in bf16 as JAX
// computes it (common.cuh's exp2_bf16), the row sum of those values in
// fp32; false is attention.cu's fp32 exponent.
#pragma once

#include <math.h>

#include "common.cuh"

namespace attention {
constexpr int BQ = 64, BKV = 32, kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // finite mask value

template <int D>
constexpr size_t smem_bytes() {
  return (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1) + BQ) * sizeof(float);
}

template <typename T, int D, bool kExpBf16>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, long long qsb,
                 long long qsh, long long qst, long long ksb, long long ksh,
                 long long kst, long long vsb, long long vsh, long long vst,
                 long long osb, long long osh, long long ost, int group,
                 int Tq, int S, float scale_log2e,
                 const int* __restrict__ lengths,
                 const int* __restrict__ offsets, int causal,
                 int latency_block) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // BQ  x (D+1)
  float* Ks = Qs + BQ * (D + 1);      // BKV x (D+1)
  float* Vs = Ks + BKV * (D + 1);     // BKV x D
  float* Ps = Vs + BKV * D;           // BQ  x (BKV+1)  rounded probabilities
  float* Zs = Ps + BQ * (BKV + 1);    // BQ             row sums

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const int len = lengths ? lengths[b] : S;
  const int off = offsets ? offsets[b] : 0;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int i = e / D, d = e % D, t = q0 + i;
    Qs[i * (D + 1) + d] = t < Tq ? to_f32(qb[t * qst + d]) : 0.f;
  }

  // score mapping: lane = key column in the tile, rows warp + kWarps * r
  constexpr int RS = BQ / kWarps;
  auto scores = [&](int k0, float* s) {
    float acc[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) acc[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = Ks[lane * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < RS; ++r)
        acc[r] = fmaf(Qs[(warp + kWarps * r) * (D + 1) + d], kd, acc[r]);
    }
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const int row = off + q0 + warp + kWarps * r;
      const bool hidden = (lengths && col >= len) || (causal && col > row) ||
                          (latency_block > 0 && col / latency_block > row / latency_block);
      // keys past S do not exist: -inf gives them probability exactly 0
      s[r] = col >= S ? -INFINITY : (hidden ? kNegInf : acc[r] * scale_log2e);
    }
  };
  auto load_rows = [&](float* dst, const T* src, long long st, int k0, int pitch) {
    for (int e = tid; e < BKV * D; e += kThreads) {
      const int j = e / D, d = e % D, kk = k0 + j;
      dst[j * pitch + d] = kk < S ? to_f32(src[kk * st + d]) : 0.f;
    }
  };

  // pass 1: row maxima
  float m[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) m[r] = -INFINITY;
  float s[RS];
  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();
    load_rows(Ks, kb, kst, k0, D + 1);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < RS; ++r) m[r] = fmaxf(m[r], warp_max(s[r]));
  }

  // pass 2: probabilities, row sums and P.V
  constexpr int ROW_STEP = kThreads / D;
  constexpr int RO = BQ / ROW_STEP;
  const int od = tid % D, orow = tid / D;
  float acc_o[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) acc_o[r] = 0.f;
  float z[RS];
#pragma unroll
  for (int r = 0; r < RS; ++r) z[r] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BKV) {
    __syncthreads();
    load_rows(Ks, kb, kst, k0, D + 1);
    load_rows(Vs, vb, vst, k0, D);
    __syncthreads();
    scores(k0, s);
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      const float e = kExpBf16 ? exp2_bf16(s[r] - m[r]) : exp2f(s[r] - m[r]);
      z[r] += e;
      Ps[(warp + kWarps * r) * (BKV + 1) + lane] = round_to<T>(e);
    }
    __syncthreads();
    const int jmax = min(BKV, S - k0);
    for (int j = 0; j < jmax; ++j) {
      const float vv = Vs[j * D + od];
#pragma unroll
      for (int r = 0; r < RO; ++r)
        acc_o[r] = fmaf(Ps[(orow + ROW_STEP * r) * (BKV + 1) + j], vv, acc_o[r]);
    }
  }

#pragma unroll
  for (int r = 0; r < RS; ++r) {
    const float zt = warp_sum(z[r]);
    if (lane == 0) Zs[warp + kWarps * r] = zt;
  }
  __syncthreads();
  T* ob = o + b * osb + h * osh;
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int i = orow + ROW_STEP * r, t = q0 + i;
    if (t < Tq) ob[t * ost + od] = from_f32<T>(acc_o[r] / Zs[i]);
  }
}

template <typename T, int D, bool kExpBf16>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int group, int Tq, int S,
           float scale_log2e, const void* lengths, const void* offsets,
           int causal, int latency_block, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<T, D, kExpBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  attention_kernel<T, D, kExpBf16><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], group, Tq, S,
      scale_log2e, static_cast<const int*>(lengths),
      static_cast<const int*>(offsets), causal, latency_block);
  return cudaGetLastError();
}

template <typename T, bool kExpBf16 = false>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                 const long long* st, int B, int H, int group, int Tq, int S,
                 float sl, const void* len, const void* off, int causal,
                 int lat, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64, kExpBf16>(q, k, v, o, st, B, H, group, Tq, S, sl, len, off, causal, lat, s);
    case 128: return launch<T, 128, kExpBf16>(q, k, v, o, st, B, H, group, Tq, S, sl, len, off, causal, lat, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attention
