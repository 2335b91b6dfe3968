// Head-major relayout of a fused q/k/v projection: (B, T, G*Dh) -> (B, G, T, Dh).
//
// Replaces ultravox_tpu/ops/pallas/fused_attention.py:qkv_head_transpose,
// which runs on the fused encoder's branch for int8 and LoRA q/k/v trees
// (the projection is a library product, then this relayout feeds
// attention_headmajor). The TPU kernel needs T to be a multiple of 128, a
// tiling rule of that chip; this one takes any T.
//
// Bound on the card: bytes. It is a pure copy with no arithmetic: every
// element is read once and written once (2 * B * T * G * Dh * sizeof(T)).
// Design: the copy is done in 16-byte units (8 bf16 or 4 fp32 values), so
// the kernel does not depend on the element type. A block takes kRows rows
// of T of one batch row, all G heads; consecutive threads take consecutive
// 16-byte units of the input rows, so the reads are contiguous, and the
// Dh * sizeof(T) / 16 threads that share one (t, g) write one contiguous
// span of the output (128 bytes for a head of 64 bf16 values). The wrapper
// takes head dims of 64 and 128 only (whole 16-byte units) and checks the
// input's 16-byte alignment; the output is a fresh allocation.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows of T per block: 125 blocks at B = 1, T = 500

__global__ void __launch_bounds__(kThreads)
    qkv_head_transpose_kernel(const int4* __restrict__ in, int4* __restrict__ out, int T, int G,
                              int head_vecs) {
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int row_vecs = G * head_vecs;  // 16-byte units in one input row
  const int n = min(kRows, T - t0) * row_vecs;
  const int4* src = in + (static_cast<long long>(b) * T + t0) * row_vecs;
  const long long out_b = static_cast<long long>(b) * G;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / row_vecs, c = e - r * row_vecs;
    const int g = c / head_vecs, d = c - g * head_vecs;
    out[((out_b + g) * T + t0 + r) * head_vecs + d] = src[e];
  }
}

}  // namespace

// in: (B, T, G * head_vecs) and out: (B, G, T, head_vecs), both contiguous,
// in 16-byte units (head_vecs = Dh * sizeof(T) / 16).
UV_EXPORT int uv_qkv_head_transpose(const void* in, void* out, int B, int T, int G, int head_vecs,
                                    void* stream) {
  if (B <= 0 || T <= 0 || G <= 0 || head_vecs <= 0 || B > 65535) return cudaErrorInvalidValue;
  dim3 grid((T + kRows - 1) / kRows, B);
  qkv_head_transpose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(in), static_cast<int4*>(out), T, G, head_vecs);
  return cudaGetLastError();
}

UV_DEFINE_ERROR_STRING(uv_qkv_head_transpose)
