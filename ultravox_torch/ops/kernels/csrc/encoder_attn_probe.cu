// The encoder-attention probes of the profiling entry point: masked,
// non-causal attention of q (B, T, H, D) against k, v (B, S, H, D), with a
// key-length mask and an exponent in fp32 or bf16.
//
// Replaces scripts/profile_encoder_attn.py:attn_v2 and :attn_nt, two TPU
// probes of the production encoder attention (fused_attention.py:
// fused_attention). Arithmetic as theirs: logits in fp32 times
// scale*log2(e); keys at or past lengths[b] get NEG_INF; exp2 against the
// row max; with the bf16 exponent, s - m is rounded to bf16 and exp2 of it
// taken as JAX computes it for a bf16 argument (exp(x * ln 2), every step
// rounded to bf16: common.cuh's exp2_bf16), and the row sum adds those
// values in fp32; PV in v's dtype with fp32
// sums; the row sum divides last. (The probes add NEG_INF where attention.cu
// replaces the logit by it: for any logit under 2^103 in magnitude the sum
// rounds to NEG_INF itself, so the two agree bit for bit.)
//
//   uv_attn_v2: q, k, v and the output head-major, (B, H, T, D) contiguous,
//     as attn_v2 runs after transposing (the wrapper makes those copies);
//   uv_attn_nt: the native (B, T, H, D) layout, read and written in place
//     through strides, as attn_nt's blocks slice it.
//
// Bound on the card: operations. At the probe shape (B 8, T = S = 1500, H
// 20, D 64) QK^T and PV are 92.16 GFLOP against 31 MB. Design: attention.cu's
// kernels, built here with the probes' exponent as a template flag: bf16 on
// the tensor cores (attention_mma.cuh: two passes over 64-key tiles so that
// the probabilities round against the global row maximum, mma.sync
// products), fp32 on the CUDA cores (attention_kernel.cuh).
#include "attention_kernel.cuh"
#include "attention_mma.cuh"

namespace {

int probe(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
          int T, int S, int H, int D, float scale_log2e, const void* lengths, int exp_bf16,
          int dtype, cudaStream_t s) {
  if (B <= 0 || T <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  if (dtype == UV_F32)
    return exp_bf16
        ? attention::dispatch_dim<float, true>(D, q, k, v, o, st, B, H, 1, T, S, scale_log2e,
                                               lengths, nullptr, 0, 0, s)
        : attention::dispatch_dim<float, false>(D, q, k, v, o, st, B, H, 1, T, S, scale_log2e,
                                                lengths, nullptr, 0, 0, s);
  if (dtype == UV_BF16)
    return exp_bf16 ? attention_mma::dispatch<true>(D, q, k, v, o, st, B, H, 1, T, S, scale_log2e,
                                                    lengths, nullptr, 0, 0, s)
                    : attention_mma::dispatch<false>(D, q, k, v, o, st, B, H, 1, T, S,
                                                     scale_log2e, lengths, nullptr, 0, 0, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, H, T, D); k, v: (B, H, S, D); all contiguous (bf16: 16-byte
// aligned). lengths: (B,) int32 or null (no mask).
UV_EXPORT int uv_attn_v2(const void* q, const void* k, const void* v, void* o, int B, int T,
                         int S, int H, int D, float scale_log2e, const void* lengths,
                         int exp_bf16, int dtype, void* stream) {
  const long long HTD = 1LL * H * T * D, HSD = 1LL * H * S * D;
  const long long st[12] = {HTD, 1LL * T * D, D, HSD, 1LL * S * D, D,
                            HSD, 1LL * S * D, D, HTD, 1LL * T * D, D};
  return probe(q, k, v, o, st, B, T, S, H, D, scale_log2e, lengths, exp_bf16, dtype,
               static_cast<cudaStream_t>(stream));
}

// q, o: (B, T, H, D); k, v: (B, S, H, D); all contiguous.
UV_EXPORT int uv_attn_nt(const void* q, const void* k, const void* v, void* o, int B, int T,
                         int S, int H, int D, float scale_log2e, const void* lengths,
                         int exp_bf16, int dtype, void* stream) {
  const long long THD = 1LL * T * H * D, SHD = 1LL * S * H * D, HD = 1LL * H * D;
  const long long st[12] = {THD, D, HD, SHD, D, HD, SHD, D, HD, THD, D, HD};
  return probe(q, k, v, o, st, B, T, S, H, D, scale_log2e, lengths, exp_bf16, dtype,
               static_cast<cudaStream_t>(stream));
}

UV_DEFINE_ERROR_STRING(uv_encoder_attn_probe)
