// Segmented decode attention: T queries per row against a read-only prompt
// cache plus a small carried tail, in one kernel.
//
// Replaces the TPU kernel ultravox_tpu/ops/pallas/segment_attention.py:
// segment_tail_attention (_seg_kernel): q (B, T, H, D) against the stacked
// (L, B, S, Hkv, D) cache at a runtime `layer` (rows layer * B + b, read in
// place, no per-layer copy) and the tail (B, Ts, Hkv, D). Query t sits at
// absolute position q_abs = n + written + t, n = lengths[b]:
//   prompt key j visible  iff j < n and (window <= 0 or q_abs - j < window);
//   tail slot s visible   iff s <= written + t and
//                             (window <= 0 or q_abs - (n + s) < window).
// The prompt keys [min_t win_lo, n), win_lo = max(q_abs - window + 1, 0),
// then the tail slots some query sees, form one virtual key range that the
// blocks of a cluster split between them (kv_split.cuh, as
// decode_attention.cu). T = 1 is the segmented decode scan's step; small
// T > 1 is a speculative verify forward.
//
// Bound on the card: bytes, as decode_attention.cu: each row reads its
// visible prompt keys/values and tail slots once; ~1 flop per byte in bf16.
// Design: a cluster of `splits` blocks per (row, kv head, chunk of (t, g)
// columns); the columns of a chunk share each 16-byte K/V load.
//
// A second entry point, uv_paged_segment_attention, replaces
// ultravox_tpu/ops/pallas/segment_attention.py:paged_segment_tail_attention
// (_paged_seg_kernel): the same attention with the prompt segment in the
// stacked (L, P, page_size, Hkv, D) pool at `layer`, row b's prompt key j in
// page min(max(table[b, j / page_size], 0), P - 1) at row j % page_size.
// It is the paged instance of the same split kernel, its own __global__
// (paged_segment_attention_split_kernel), so a trace tells the two apart.
// Bound as the contiguous form, plus a page lookup that must stay off the
// chain of dependent loads: each key step's page ids load one step ahead,
// beside the K/V loads, and j / page_size is a multiply-high (any page
// size). The TPU kernel starts at the page of the lowest window bound; this
// one starts at the exact key, as the contiguous form does.
#include "kv_split.cuh"

UV_KV_SPLIT_KERNEL(segment_attention_split_kernel, false)
UV_KV_SPLIT_KERNEL(paged_segment_attention_split_kernel, true)

// strides: 10 element strides: q (batch, query, head), cache (layer, batch,
// seq, head; k and v share them), tail (batch, slot, head; tail k and v
// share them); every head dimension is contiguous. lengths, written: (B,)
// int32. splits: blocks per cluster (1-8), chosen from S + Ts. Writes o
// (B, T, H, D) contiguous in q's dtype. The cache, the tail and their
// strides in bytes are multiples of 16.
UV_EXPORT int uv_segment_attention(const void* q, const void* k, const void* v, const void* tk,
                                   const void* tv, void* o, const long long* strides,
                                   const void* lengths, const void* written, int layer,
                                   int window, int B, int T, int H, int G, int S, int Ts, int D,
                                   float scale, int splits, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G || S <= 0 || Ts <= 0 || layer < 0)
    return cudaErrorInvalidValue;
  kvsplit::Params p = {};
  p.q = q, p.o = o, p.k = k, p.v = v, p.tk = tk, p.tv = tv;
  p.q_b = strides[0], p.q_t = strides[1], p.q_h = strides[2];
  p.o_b = static_cast<long long>(T) * H * D, p.o_t = static_cast<long long>(H) * D, p.o_h = D;
  p.c_l = strides[3], p.c_b = strides[4], p.c_s = strides[5], p.c_h = strides[6];
  p.t_b = strides[7], p.t_s = strides[8], p.t_h = strides[9];
  p.lengths = static_cast<const int*>(lengths);
  p.written = static_cast<const int*>(written);
  p.layer = layer, p.window = window, p.T = T, p.G = G, p.S = S, p.Ts = Ts, p.decode = 0;
  p.scale = scale;
  return segment_attention_split_kernel_dispatch(dtype, D, p, B, H / G, splits,
                                                 static_cast<cudaStream_t>(stream));
}

// strides: 10 element strides: q (batch, query, head), pool (layer, page,
// row in page, head; k and v share them), tail (batch, slot, head; tail k
// and v share them); every head dimension is contiguous. table: (B, n_per)
// int32 contiguous; lengths, written: (B,) int32. splits: blocks per
// cluster (1-8), chosen from n_per * page_size + Ts. Writes o (B, T, H, D)
// contiguous in q's dtype. The pool, the tail and their strides in bytes
// are multiples of 16.
UV_EXPORT int uv_paged_segment_attention(const void* q, const void* k, const void* v,
                                         const void* tk, const void* tv, void* o,
                                         const long long* strides, const void* table,
                                         const void* lengths, const void* written, int layer,
                                         int window, int B, int T, int H, int G, int n_per,
                                         int page_size, int num_pages, int Ts, int D,
                                         float scale, int splits, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || G <= 0 || H % G || n_per <= 0 || page_size <= 0 ||
      num_pages <= 0 || Ts <= 0 || layer < 0)
    return cudaErrorInvalidValue;
  kvsplit::Params p = {};
  p.q = q, p.o = o, p.k = k, p.v = v, p.tk = tk, p.tv = tv;
  p.q_b = strides[0], p.q_t = strides[1], p.q_h = strides[2];
  p.o_b = static_cast<long long>(T) * H * D, p.o_t = static_cast<long long>(H) * D, p.o_h = D;
  p.c_l = strides[3], p.c_p = strides[4], p.c_s = strides[5], p.c_h = strides[6];
  p.t_b = strides[7], p.t_s = strides[8], p.t_h = strides[9];
  p.table = static_cast<const int*>(table);
  p.n_per = n_per, p.num_pages = num_pages;
  kvsplit::set_page_size(p, page_size);
  p.lengths = static_cast<const int*>(lengths);
  p.written = static_cast<const int*>(written);
  p.layer = layer, p.window = window, p.T = T, p.G = G, p.S = n_per * page_size, p.Ts = Ts;
  p.decode = 0, p.scale = scale;
  return paged_segment_attention_split_kernel_dispatch(dtype, D, p, B, H / G, splits,
                                                       static_cast<cudaStream_t>(stream));
}

UV_DEFINE_ERROR_STRING(uv_segment_attention)
