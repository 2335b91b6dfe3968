// A 32-row x 128-column output tile of (rows, K) x (K, C), with the 32 rows
// of the left operand held whole in shared memory as fp32 and the weight
// streamed through it in 32 x 128 tiles. The fp32 (and unaligned bf16)
// route of the kernels whose left operand is made inside the kernel and
// never reaches HBM:
//   - ln_qkv_head.cu and ln_matmul_gelu.cu (LayerNorm'd rows);
//   - attn_out_proj.cu (attention heads gathered from (B, H, T, Dh)).
// Each thread accumulates a 4 x 4 register tile with fp32 FMAs (CUDA cores:
// fp32 on the tensor cores would be TF32; bf16 runs mma_rows.cuh); the
// caller writes its own epilogue from `acc`.
#pragma once

#include "common.cuh"

namespace row_tile {

constexpr int BM = 32, BN = 128, BK = 32, kThreads = 256;

// dynamic shared memory of one block: BM x K rows, then a BK x BN weight tile
inline size_t smem_bytes(int K) {
  return (static_cast<size_t>(BM) * K + BK * BN) * sizeof(float);
}
constexpr size_t kMaxSmem = 232448;  // the 227 KB a block may use on sm_90

// LayerNorm of rows row0 .. row0 + BM of x (rows, D) into Hs (BM x D): fp32
// statistics and affine, the result rounded to T. Rows past `rows` are 0.
// Each warp normalises BM / 8 rows; a lane reads back only the elements it
// wrote itself, so no barrier is needed inside a row. The caller syncs.
template <typename T>
__device__ __forceinline__ void layer_norm_rows(float* Hs, const T* __restrict__ x,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb, int row0,
                                                int rows, int D, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BM; r += kThreads / 32) {
    float* h = Hs + r * D;
    const int row = row0 + r;
    if (row >= rows) {
      for (int i = lane; i < D; i += 32) h[i] = 0.f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(row) * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = to_f32(xr[i]);
      h[i] = v;
      s += v;
    }
    const float mean = warp_sum(s) / D;
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float c = h[i] - mean;
      ss += c * c;
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + eps);
    for (int i = lane; i < D; i += 32)
      h[i] = round_to<T>((h[i] - mean) * rstd * lns[i] + lnb[i]);
  }
}

// acc[r][c] = sum_k As[(ty * 4 + r) * K + k] * w[k * C + n0 + tx * 4 + c] for
// thread (ty, tx) = (tid / 32, tid % 32); columns past C read 0. As must be
// complete (the caller syncs after filling it); Ws is the BK x BN scratch.
template <typename T>
__device__ __forceinline__ void product(const float* As, float* Ws, const T* __restrict__ w,
                                        int K, int C, int n0, float (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = k0 + e / BN, n = n0 + e % BN;
      Ws[e] = (k < K && n < C) ? to_f32(w[static_cast<size_t>(k) * C + n]) : 0.f;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(Ws + kk * BN + tx * 4);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = As[(ty * 4 + r) * K + k0 + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a, b4[c], acc[r][c]);
      }
    }
    __syncthreads();
  }
}

}  // namespace row_tile
