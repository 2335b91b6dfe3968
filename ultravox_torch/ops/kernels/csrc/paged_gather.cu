// Page gather: the contiguous per-row K/V views of a paged pool.
//
// Replaces the TPU kernel ultravox_tpu/ops/pallas/paged_gather.py:
// gather_pages (_gather_kernel): the (L, P, page_size, Hkv, D) k and v pools
// become (L, B, n_per * page_size, Hkv, D) views, page i of row b being pool
// page min(table[b, i], P - 1). Every entry of the views is written,
// sentinel (unallocated) entries included, which copy page P - 1: the
// attention masks downstream are additive, so the data they hide must be
// finite, and unwritten memory could hold NaN bit patterns.
//
// Bound on the card: bytes. It is a pure copy: each listed page is read
// once and written once, no arithmetic. Design: one block per (logical page,
// row, layer) copies that page of k and of v with 16-byte loads and stores,
// consecutive threads on consecutive 16 bytes. A page is page_size * Hkv * D
// contiguous elements (256 KB of bf16 at page size 256, 8 kv heads, head dim
// 64). The wrapper checks that every page and both bases are 16-byte
// aligned and raises otherwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    paged_gather_kernel(const int4* __restrict__ k, const int4* __restrict__ v, int4* ko, int4* vo,
                        const int* __restrict__ table, long long l_stride, long long p_stride,
                        long long page, int n_per, int B, int P) {
  const int i = blockIdx.x, b = blockIdx.y, l = blockIdx.z;
  const int pid = min(max(table[static_cast<long long>(b) * n_per + i], 0), P - 1);
  const long long src = l * l_stride + pid * p_stride;
  const long long dst = ((static_cast<long long>(l) * B + b) * n_per + i) * page;
  for (long long e = threadIdx.x; e < page; e += kThreads) {
    ko[dst + e] = k[src + e];
    vo[dst + e] = v[src + e];
  }
}

}  // namespace

// Strides and the page length are in 16-byte units: l_stride between
// layers of the pool, p_stride between pages, page the length of one page.
// table: (B, n_per) int32 contiguous. Writes ko, vo (L, B, n_per, page)
// contiguous.
UV_EXPORT int uv_paged_gather(const void* k, const void* v, void* ko, void* vo, const void* table,
                              long long l_stride, long long p_stride, long long page, int L,
                              int B, int n_per, int P, void* stream) {
  if (L <= 0 || B <= 0 || n_per <= 0 || P <= 0 || page <= 0 || B > 65535 || L > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(n_per, B, L);
  paged_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(k), static_cast<const int4*>(v), static_cast<int4*>(ko),
      static_cast<int4*>(vo), static_cast<const int*>(table), l_stride, p_stride, page, n_per, B,
      P);
  return cudaGetLastError();
}

UV_DEFINE_ERROR_STRING(uv_paged_gather)
