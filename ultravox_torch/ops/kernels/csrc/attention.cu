// Scaled dot-product attention with masks computed from scalars.
//
// Replaces two TPU kernels of ultravox_tpu/ops/pallas/fused_attention.py:
//   - attention_headmajor (_headmajor_kernel): encoder self-attention over a
//     packed head-major (B, 3H, T, Dh) array, q/k/v at head offsets 0/H/2H;
//   - fused_attention (_attn_kernel): (B, T, H, D) queries against
//     (B, S, Hkv, D) keys/values with GQA (kv head = h / group), used for
//     causal prefill into the decoder's KV cache.
// Both are one kernel here: the wrappers pass element strides, so any of
// these layouts is read in place and no transpose is ever materialised.
//
// Numerics follow the TPU kernels: logits = (q . k) in fp32 times
// scale*log2(e); masked entries are replaced by the finite NEG_INF; the
// softmax uses exp2 against the row's global maximum; the probabilities are
// rounded to the value dtype before the PV product, accumulated in fp32,
// and the row sum (of the unrounded probabilities) divides the output last.
// Masks: key j is hidden when j >= lengths[b] (if given), when causal and
// j > row, or when j / latency_block > row / latency_block; row is the
// query's absolute position offsets[b] + t.
//
// Bound on the card: bytes at these shapes (encoder: 4 x 12 heads x 500^2
// x 64, prefill: 4 x 32 heads x 128 x 128 visible keys x 64; ~100
// flop/byte, under the ~295 ridge); at the probes' 1500 keys, operations.
// Either way the work is products of 64-row tiles, so bf16 runs on the
// tensor cores: attention_mma.cuh (mma.sync m16n8k16, two passes over the
// key tiles the rows can see, so P rounds against the global row maximum
// and prefill into a 2048-slot cache stops at its last visible key). fp32
// keeps the CUDA-core kernel of attention_kernel.cuh: fp32 on the tensor
// cores would be TF32, whose 10-bit mantissa breaks the 1e-5 agreement with
// the plain version that the fp32 checks hold.
#include "attention_kernel.cuh"
#include "attention_mma.cuh"

// strides: 12 element strides (batch, head, row) for q, k, v, o in that
// order; the head dimension is contiguous (bf16: every pointer and stride
// 16-byte aligned, else cudaErrorMisalignedAddress). lengths, offsets: (B,)
// int32 or null, offsets >= 0. Returns (B, H, Tq, D) values at o's strides
// in q's dtype.
UV_EXPORT int uv_attention(const void* q, const void* k, const void* v,
                           void* o, const long long* strides, int B, int H,
                           int group, int Tq, int S, int D, float scale_log2e,
                           const void* lengths, const void* offsets,
                           int causal, int latency_block, int dtype,
                           void* stream) {
  if (B <= 0 || H <= 0 || group <= 0 || H % group || Tq <= 0 || S <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32)
    return attention::dispatch_dim<float>(D, q, k, v, o, strides, B, H, group, Tq, S,
                                          scale_log2e, lengths, offsets, causal, latency_block, s);
  if (dtype == UV_BF16)
    return attention_mma::dispatch<false>(D, q, k, v, o, strides, B, H, group, Tq, S,
                                          scale_log2e, lengths, offsets, causal, latency_block, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_attention)
