// One-token decode attention against a contiguous KV cache slab.
//
// Replaces the TPU kernel ultravox_tpu/ops/pallas/decode_attention.py:
// decode_attention (_decode_kernel): q (B, H, D), one query per row, against
// the cache slab (B, S, Hkv, D) of one layer, keys in
// [max(n - window, 0), n) for window > 0 else [0, n), n = lengths[b], GQA.
// The window is a runtime argument, so one build serves local and global
// layers. The slab is read in place at its strides (cache.k[l] of the
// stacked (L, B, S, Hkv, D) cache is such a view): no copy, no transpose.
// Unlike the TPU kernel, which loops over whole 256-key blocks and masks
// inside them, the key loop starts and stops exactly at the window and the
// length. The TPU layout tricks (block-diagonal queries, 128-lane views)
// exist only for Mosaic and are not reproduced.
//
// Bound on the card: bytes. Each row reads its visible keys and values once
// (2 * n * Hkv * D elements); the arithmetic is 4 * H * n * D flops, ~1 flop
// per byte in bf16, far under the ~295 flop/byte ridge. Design
// (kv_split.cuh): the keys of each (row, kv head) are split across a cluster
// of `splits` blocks, which merge their partial softmax states through
// distributed shared memory; lanes load 16-byte pieces of K and V rows into
// registers, and the G query heads of a group share each load (GQA). At the
// flagship decode shape that is 8 x 8 x 4 = 256 blocks on 132 SMs.
#include "kv_split.cuh"

UV_KV_SPLIT_KERNEL(decode_attention_split_kernel, false)

// strides: 5 element strides: q (batch, head), cache (batch, seq, head); k
// and v share them, and the head dimension is contiguous. lengths: (B,)
// int32. splits: blocks per cluster (1-8), chosen from S. Writes o (B, H, D)
// contiguous in q's dtype. k, v, their strides and the head dim in bytes are
// multiples of 16.
UV_EXPORT int uv_decode_attention(const void* q, const void* k, const void* v, void* o,
                                  const long long* strides, const void* lengths, int window,
                                  int B, int H, int G, int S, int D, float scale, int splits,
                                  int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G || S <= 0) return cudaErrorInvalidValue;
  kvsplit::Params p = {};
  p.q = q, p.o = o, p.k = k, p.v = v;
  p.q_b = strides[0], p.q_h = strides[1];
  p.o_b = static_cast<long long>(H) * D, p.o_h = D;
  p.c_b = strides[2], p.c_s = strides[3], p.c_h = strides[4];
  p.lengths = static_cast<const int*>(lengths);
  p.window = window, p.T = 1, p.G = G, p.S = S, p.decode = 1, p.scale = scale;
  return decode_attention_split_kernel_dispatch(dtype, D, p, B, H / G, splits,
                                                static_cast<cudaStream_t>(stream));
}

UV_DEFINE_ERROR_STRING(uv_decode_attention)
