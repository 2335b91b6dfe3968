// Tensor-core tile primitives for attention kernels on Hopper (sm_90a),
// written as inline PTX: cp.async copies into shared memory, ldmatrix
// fragment loads and mma.sync.m16n8k16 bf16 products with fp32 sums.
//
// Conventions. A tile holds R rows of D bf16 values in shared memory with a
// pitch of D + 8 elements: 16 bytes of padding put the eight rows that one
// ldmatrix phase reads on eight different bank groups, so no load conflicts.
// A warp owns 16 rows of a product. An accumulator `acc[n][e]` of a 16 x 8N
// fp32 tile holds, in lane (g = lane / 4, t = lane % 4), the element at row
// g + 8 * (e / 2) and column 8 n + 2 t + (e % 2): the mma C layout. That is
// also the A layout of the next product over those columns (FlashAttention-2),
// so probabilities become A fragments in registers (`pack_a`) without a
// trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tile {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zero-filled when
// !valid (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 or 8 bytes, zero-filled when !valid (cp.async.ca takes sizes 4, 8, 16)
template <int N>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src, bool valid) {
  static_assert(N == 4 || N == 8, "cp.async.ca copies 4 or 8 bytes here");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(N), "r"(valid ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16 x 16 bf16, row) . b (16 x 8 bf16, col), fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
struct Tile {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kPitch = D + 8;  // elements per shared-memory row
  static constexpr int kChunks = D / 8;  // 16-byte pieces per row
  template <int R>
  static constexpr int bytes() { return R * kPitch * (int)sizeof(bf16); }
};

// Rows [r0, r0 + R) of a row-major bf16 matrix (row stride `stride`
// elements, 16-byte aligned rows) into a tile, asynchronously, by THREADS
// threads; rows outside [0, n) are zero-filled, so that a product with them
// gives 0 and never NaN from stale shared memory.
template <int D, int R, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride, int r0,
                                          int n) {
  constexpr int C = Tile<D>::kChunks;
  static_assert(R * C % THREADS == 0, "every thread copies as many pieces");
#pragma unroll
  for (int i = 0; i < R * C / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS, j = e / C, c = e % C, r = r0 + j;
    const bool ok = r >= 0 && r < n;
    cp_async16(dst + j * Tile<D>::kPitch + c * 8, ok ? src + r * stride + c * 8 : src, ok);
  }
}

// acc (16 x 16 NP) = A[a_row0, a_row0 + 16) . B[0, 16 NP)^T over D, both
// tiles in shared memory (NP = 4: a 64-column logit tile). The sum over D
// runs in 16-wide steps in ascending order, one mma per step and element,
// the same instruction sequence wherever it is called, so the same row
// pair gives bit-equal sums in every kernel (the products are exact, so
// which operand is A does not matter either).
template <int D, int NP = 4>
__device__ __forceinline__ void s_tile(float (&acc)[2 * NP][4], const bf16* A, int a_row0,
                                       const bf16* B) {
  constexpr int P = Tile<D>::kPitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < 2 * NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (a_row0 + (lane & 15)) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// A fragments of a 16 x 64 product over its 64 columns, from a 16 x 64
// accumulator (already transformed), each value rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&p)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc (16 x D) += P (16 x 64, A fragments) . V[0, 64) with V a tile in
// shared memory (64 rows of D), read transposed by ldmatrix
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4], const uint32_t (&p)[4][4],
                                        const bf16* V) {
  constexpr int P = Tile<D>::kPitch;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, V + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp * 16 +
                           (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], p[kk], b[2], b[3]);
    }
  }
}

// Row (0..15) and column (0..8N) within the warp's tile of accumulator
// element [n][e] in this lane.
__device__ __forceinline__ int acc_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int n, int e) {
  return 8 * n + 2 * (threadIdx.x & 3) + (e & 1);
}

// Store a warp's 16 x D accumulator, row r divided by div[r >= 8] and
// rounded to bf16, to rows [row0, row0 + 16) of a row-major global matrix
// (rows at or past n are skipped): through `stage`, 16 rows of this warp's
// own tile in shared memory, so the global stores are 16-byte lines.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const float (&div)[2],
                                           bf16* stage, bf16* dst, long long stride, int row0,
                                           int n) {
  constexpr int P = Tile<D>::kPitch, C = Tile<D>::kChunks;
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int d = 0; d < D / 8; ++d)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = acc_row(2 * h), c = acc_col(d, 0);
      *reinterpret_cast<uint32_t*>(stage + r * P + c) =
          pack_bf16(acc[d][2 * h] / div[h], acc[d][2 * h + 1] / div[h]);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * C / 32; ++i) {
    const int e = lane + 32 * i, j = e / C, c = e % C, r = row0 + j;
    if (r < n)
      *reinterpret_cast<uint4*>(dst + r * stride + c * 8) =
          *reinterpret_cast<const uint4*>(stage + j * P + c * 8);
  }
}

}  // namespace mma_tile
