// One-token decode attention against a paged KV pool.
//
// Replaces the TPU kernel ultravox_tpu/ops/pallas/paged_attention.py:
// paged_decode_attention (_paged_decode_kernel): q (B, H, D), one query per
// row, against one layer's pool (P, page_size, Hkv, D) through a (B, n_per)
// int32 page table; row b's key j lives in page table[b, j / page_size] at
// row j % page_size. Keys in [max(n - window, 0), n) for window > 0 else
// [0, n), n = lengths[b], GQA. Table ids clamp to [0, P - 1], so a sentinel
// (unallocated) entry reads finite data of the pool and never faults: a
// pageless inactive slot (length 1, every entry the sentinel) reads row 0
// of page P - 1, and its output is ignored. The TPU layout tricks
// (block-diagonal queries, (P, ps, Hkv * D) views, triple-buffered page
// DMAs) exist only for Mosaic and are not reproduced.
//
// Bound on the card: bytes, and at decode sizes latency, as
// decode_attention.cu: each row reads its visible keys and values once
// (~1 flop per byte in bf16), so the time is set by how many blocks run and
// by each block's chain of dependent loads, and a page lookup in that chain
// would add a dependent global load to every key step. Design: the split
// kernel of decode_attention.cu (kv_split.cuh) in its paged instance
// (paged_decode_attention_split_kernel): a cluster of `splits` blocks per
// (row, kv head) splits the row's visible keys; each key step's page ids
// load one step ahead, beside the K/V loads, and j / page_size is a
// multiply-high (any page size).
#include "kv_split.cuh"

UV_KV_SPLIT_KERNEL(paged_decode_attention_split_kernel, true)

// strides: 5 element strides: q (batch, head), pool (page, row in page,
// head); k and v share them, and the head dimension is contiguous. table:
// (B, n_per) int32 contiguous; lengths: (B,) int32. splits: blocks per
// cluster (1-8), chosen from n_per * page_size. Writes o (B, H, D)
// contiguous in q's dtype. The pool and its strides in bytes are multiples
// of 16.
UV_EXPORT int uv_paged_attention(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, const void* table,
                                 const void* lengths, int window, int B, int H, int G,
                                 int n_per, int page_size, int num_pages, int D, float scale,
                                 int splits, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || n_per <= 0 || page_size <= 0 || num_pages <= 0)
    return cudaErrorInvalidValue;
  kvsplit::Params p = {};
  p.q = q, p.o = o, p.k = k, p.v = v;
  p.q_b = strides[0], p.q_h = strides[1];
  p.o_b = static_cast<long long>(H) * D, p.o_h = D;
  p.c_p = strides[2], p.c_s = strides[3], p.c_h = strides[4];
  p.table = static_cast<const int*>(table);
  p.n_per = n_per, p.num_pages = num_pages;
  kvsplit::set_page_size(p, page_size);
  p.lengths = static_cast<const int*>(lengths);
  p.window = window, p.T = 1, p.G = G, p.S = n_per * page_size, p.decode = 1, p.scale = scale;
  return paged_decode_attention_split_kernel_dispatch(dtype, D, p, B, H / G, splits,
                                                      static_cast<cudaStream_t>(stream));
}

UV_DEFINE_ERROR_STRING(uv_paged_attention)
