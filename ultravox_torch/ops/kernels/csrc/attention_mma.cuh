// The bf16 attention kernel of attention.cu and encoder_attn_probe.cu on the
// tensor cores (mma_tile.cuh), with the masks of attn_mask.cuh.
//
// What it computes is attention_kernel.cuh's (the fp32 path): logits =
// (q . k) in fp32 (bf16 operands, fp32 sums) times scale*log2(e), applied
// with __fmul_rn so both passes round every logit alike; hidden keys get the
// finite NEG_INF, keys past S -inf; exp2 against the row's global maximum;
// the row sum over the unrounded exponentials; P rounded to bf16 before
// P.V with fp32 sums; the division by the row sum last. kExpBf16 is the
// probes' exponent: exp2 of s - m in bf16 as JAX computes it (common.cuh's
// exp2_bf16), the row sum of those values in fp32. Key j is hidden from absolute row
// offsets[b] + t when j >= lengths[b], when causal and j > row, or when
// j / latency_block > row / latency_block. Offsets are non-negative, so
// key 0 is visible to every row unless lengths[b] <= 0; such a row averages
// v over all S keys, as the reference does.
//
// Design: a block owns 64 query rows of one (b, h), 4 warps of 16 rows
// each. It makes two passes over the key tiles of 64 that its rows can see
// (key_range: from 0 to min(S, lengths[b], the last row + 1 if causal, the
// end of its latency block)); a key past them gets exp2(NEG_INF - m) = 0 in
// every row that sees a key, so stopping there is exact, and prefill into a
// long cache costs its visible keys, not its slots. Pass 1 takes each row's
// maximum; pass 2 rebuilds the same logits (mma_tile::s_tile), takes exp2,
// sums and packs P to bf16 straight into A fragments for O += P V. Tiles
// come in by cp.async in a 2-stage ring, through the strides the wrapper
// passes (any (batch, head, row) layout with a contiguous head dimension),
// rows past Tq and keys past S zero-filled, so no stale value enters a
// product. A tile that the mask leaves whole skips the mask. At head_dim 64
// the kernel is held to 128 registers, so 4 blocks share an SM. Measured on
// an H100 against 32- and 16-row blocks (more blocks for the encoder and
// prefill at batch 1): 64 rows was as fast or faster at every main-path
// shape, since a smaller block shares each key tile among fewer rows.
#pragma once

#include <math.h>

#include "attn_mask.cuh"
#include "common.cuh"
#include "mma_tile.cuh"

namespace attention_mma {

namespace mt = mma_tile;
using mt::bf16;
using namespace attn_mask;

struct Params {
  long long qs[3], ks[3], vs[3], os[3];  // (batch, head, row) element strides
  int group, Tq, S;
  float scale_log2e;
  const int* lengths;  // (B,) or null
  const int* offsets;  // (B,) or null
  int causal, lb;
};

constexpr int BQ = 64, TK = 64, kThreads = 128;  // query rows, keys, threads per block

template <int D, bool kExpBf16>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 1)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, const Params p) {
  constexpr int P = mt::Tile<D>::kPitch, KTILE = TK * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ rows
  bf16* Ks = Qs + BQ * P;                         // 2 stages
  bf16* Vs = Ks + 2 * KTILE;                      // 2 stages

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qb = q + b * p.qs[0] + h * p.qs[1];
  const bf16* kb = k + b * p.ks[0] + hk * p.ks[1];
  const bf16* vb = v + b * p.vs[0] + hk * p.vs[1];
  const int S = p.S, off = p.offsets ? p.offsets[b] : 0;
  const Mask mk{S, p.lengths ? p.lengths[b] : S, p.causal, 0, p.lb};
  const Range rg = key_range(mk, off + q0, off + min(q0 + BQ, p.Tq));
  const int lo = rg.full ? 0 : rg.lo, hi = rg.full ? S : rg.hi;
  const int ntiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const Span sp[2] = {row_span(mk, off + r0 + mt::acc_row(0)),
                      row_span(mk, off + r0 + mt::acc_row(2))};

  // the logits of key tile k0 in this warp's rows from their products s;
  // keys past S get -inf (rows past Tq are never stored). Three paths: a
  // tile the mask leaves whole, the last tile of an unmasked row (keys past
  // S only), and a masked tile.
  auto scale_mask = [&](float (&s)[8][4], int k0) {
    const bool open = tile_open<BQ, TK>(mk, off + q0, k0);
    const int past = S - k0 - 2 * (lane & 3);  // offsets 8 n + c from here are past S
    if (open && keys_in_range<TK>(mk, k0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], p.scale_log2e);
    } else if (open) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = 8 * n + (e & 1) >= past ? -INFINITY : __fmul_rn(s[n][e], p.scale_log2e);
    } else {
      const Local l[2] = {local(sp[0], k0), local(sp[1], k0)};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 8 * n + (e & 1);
          s[n][e] = x >= past ? -INFINITY : logit(l[e >> 1].hides(x), s[n][e], p.scale_log2e);
        }
    }
  };

  // pass 1: row maxima (K only)
  mt::load_tile<D, BQ, kThreads>(Qs, qb, p.qs[2], q0, p.Tq);
  if (ntiles > 0) mt::load_tile<D, TK, kThreads>(Ks, kb, p.ks[2], lo, S);
  mt::cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * TK;
    if (it + 1 < ntiles)
      mt::load_tile<D, TK, kThreads>(Ks + ((it + 1) & 1) * KTILE, kb, p.ks[2], k0 + TK, S);
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    mt::s_tile<D>(s, Qs, 16 * warp, Ks + (it & 1) * KTILE);
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
    mt::load_tile<D, TK, kThreads>(Ks, kb, p.ks[2], lo, S);
    mt::load_tile<D, TK, kThreads>(Vs, vb, p.vs[2], lo, S);
  }
  mt::cp_async_commit();
  float acc[D / 8][4] = {};
  float z[2] = {0.f, 0.f};
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = lo + it * TK, st = it & 1;
    if (it + 1 < ntiles) {
      mt::load_tile<D, TK, kThreads>(Ks + (st ^ 1) * KTILE, kb, p.ks[2], k0 + TK, S);
      mt::load_tile<D, TK, kThreads>(Vs + (st ^ 1) * KTILE, vb, p.vs[2], k0 + TK, S);
    }
    mt::cp_async_commit();
    mt::cp_async_wait<1>();
    __syncthreads();
    float s[8][4];
    mt::s_tile<D>(s, Qs, 16 * warp, Ks + st * KTILE);
    scale_mask(s, k0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = s[n][e] - m[e >> 1];
        const float ex = kExpBf16 ? exp2_bf16(d) : exp2f(d);
        z[e >> 1] += ex;
        s[n][e] = ex;
      }
    uint32_t pa[4][4];
    mt::pack_a(pa, s);
    mt::pv_tile<D>(acc, pa, Vs + st * KTILE);
    __syncthreads();
  }
  mt::cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed before Qs is reused
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 1);
    z[i] += __shfl_xor_sync(0xffffffffu, z[i], 2);
  }
  // this warp's 16 rows of Qs were read by this warp alone
  mt::store_rows<D>(acc, z, Qs + 16 * warp * P, o + b * p.os[0] + h * p.os[1], p.os[2], r0,
                    p.Tq);
}

template <int D, bool kExpBf16>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p, int B, int H,
           cudaStream_t stream) {
  constexpr size_t smem = (size_t)(BQ + 4 * TK) * mt::Tile<D>::kPitch * sizeof(bf16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(attention_mma_kernel<D, kExpBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((p.Tq + BQ - 1) / BQ, H, B);
  attention_mma_kernel<D, kExpBf16><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), p);
  return cudaGetLastError();
}

// cp.async and the 16-byte stores need every base pointer and every stride
// 16-byte aligned (the wrapper raises first; this keeps the C entry safe)
inline bool aligned16(const void* q, const void* k, const void* v, const void* o,
                      const Params& p) {
  uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  for (int i = 0; i < 3; ++i) bits |= 2 * (p.qs[i] | p.ks[i] | p.vs[i] | p.os[i]);
  return bits % 16 == 0;
}

// strides: 12 element strides (batch, head, row) of q, k, v, o in that order
template <bool kExpBf16>
int dispatch(int D, const void* q, const void* k, const void* v, void* o, const long long* st,
             int B, int H, int group, int Tq, int S, float scale_log2e, const void* lengths,
             const void* offsets, int causal, int latency_block, cudaStream_t s) {
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  Params p{};
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = st[i];
    p.ks[i] = st[3 + i];
    p.vs[i] = st[6 + i];
    p.os[i] = st[9 + i];
  }
  p.group = group;
  p.Tq = Tq;
  p.S = S;
  p.scale_log2e = scale_log2e;
  p.lengths = static_cast<const int*>(lengths);
  p.offsets = static_cast<const int*>(offsets);
  p.causal = causal;
  p.lb = latency_block;
  if (!aligned16(q, k, v, o, p)) return cudaErrorMisalignedAddress;
  switch (D) {
    case 64: return launch<64, kExpBf16>(q, k, v, o, p, B, H, s);
    case 128: return launch<128, kExpBf16>(q, k, v, o, p, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attention_mma
