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
// What set the pace of a copy by thread loads was latency, not bytes: at
// one request, (1, 500, 2304) bf16, a grid of 125 blocks had ~0.5 MB in
// flight across the card, which caps the rate near 0.9 TB/s.
//
// Design: the loads go through Hopper's bulk asynchronous copies (the TMA
// engine, 1-D form, no tensor map), so a block's whole tile is in flight at
// once and no register waits on it. A block owns `rows` rows of T of one
// batch row and `heads` heads (all G where shared memory allows); each
// row's heads are heads * Dh * sizeof(T) contiguous bytes of the input.
// Thread 0 arms an mbarrier with the tile's byte count, then the first
// warp's lanes issue one bulk copy per row into shared memory ([r][g][d]).
// Once the barrier's phase completes, the block's threads store the tile
// in 16-byte units, consecutive threads on consecutive units of one head's
// rows (rows * Dh * sizeof(T) contiguous bytes of the output). A store does
// not hold its thread, so thread stores keep as many bytes in flight as the
// loads did; on the H100 they measured faster than one bulk store per head
// (with or without a relayout in shared memory first) and than one bulk
// load per head row (PERF.md). The element type sets only the byte count:
// one kernel serves bf16 and fp32. The host's plan
// (ops/kernels/fused_attention.py:_transpose_plan) picks rows and heads; the
// wrapper takes head dims of 64 and 128 (whole 16-byte units, as bulk
// copies need) and checks the input's 16-byte alignment; the output is a
// fresh allocation.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kThreads)
    qkv_head_transpose_kernel(const char* __restrict__ in, char* __restrict__ out, int T, int G,
                              int R, int GB, int head_bytes) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(128) unsigned char tile[];  // [rows][heads][head_bytes]
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * R, g0 = blockIdx.y * GB, b = blockIdx.z;
  const int rows = min(R, T - t0), heads = min(GB, G - g0);
  const int row_bytes = heads * head_bytes;
  const uint32_t bar_s = smem_addr(&bar), tile_s = smem_addr(tile);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the one arrival, with the bytes every copy below will complete
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar_s),
                 "r"(rows * row_bytes)
                 : "memory");
  }
  __syncthreads();
  const char* src0 = in + ((static_cast<size_t>(b) * T + t0) * G + g0) * head_bytes;
  if (tid < 32)
    for (int r = tid; r < rows; r += 32)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(tile_s + r * row_bytes), "l"(src0 + static_cast<size_t>(r) * G * head_bytes),
          "r"(row_bytes), "r"(bar_s)
          : "memory");
  // every copy has landed once phase 0 completes
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}" ::"r"(bar_s)
      : "memory");
  // unit j of head g's span (rows * units contiguous 16-byte units of the
  // output) is unit (r, d) of its row: r = j / units, d = j % units
  const int units = head_bytes / 16, shift = __ffs(units) - 1, span = rows * units;
  const int4* t4 = reinterpret_cast<const int4*>(tile);
  char* dst0 = out + ((static_cast<size_t>(b) * G + g0) * T + t0) * head_bytes;
  for (int e = tid; e < heads * span; e += kThreads) {
    const int g = e / span, j = e - g * span;
    reinterpret_cast<int4*>(dst0 + static_cast<size_t>(g) * T * head_bytes)[j] =
        t4[((j >> shift) * heads + g) * units + (j & (units - 1))];
  }
}

}  // namespace

// in: (B, T, G, head_bytes) and out: (B, G, T, head_bytes) in bytes, both
// contiguous and 16-byte aligned, head_bytes a power-of-two count of 16-byte
// units. A block owns `rows` rows of T and `heads` heads of one batch row
// (rows * heads * head_bytes bytes of shared memory).
UV_EXPORT int uv_qkv_head_transpose(const void* in, void* out, int B, int T, int G, int head_bytes,
                                    int rows, int heads, void* stream) {
  // head_bytes: 16-byte units, a power of two of them
  if (B <= 0 || T <= 0 || G <= 0 || head_bytes <= 0 || head_bytes % 16 ||
      (head_bytes / 16 & (head_bytes / 16 - 1)) || rows <= 0 || heads <= 0 || heads > G ||
      B > 65535)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  const size_t smem = static_cast<size_t>(rows) * heads * head_bytes;
  const int groups = (G + heads - 1) / heads;
  if (smem > 232448 - 16 || groups > 65535) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(qkv_head_transpose_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((T + rows - 1) / rows, groups, B);
  qkv_head_transpose_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(in), static_cast<char*>(out), T, G, rows, heads, head_bytes);
  return cudaGetLastError();
}

UV_DEFINE_ERROR_STRING(uv_qkv_head_transpose)
