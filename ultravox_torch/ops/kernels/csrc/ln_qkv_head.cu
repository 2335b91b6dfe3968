// LayerNorm -> qkv projection -> head-major relayout, in one kernel:
// (B, T, D) x (D, C) + bias -> (B, G, T, Dh), G = C / Dh = 3 * num_heads.
//
// Replaces ultravox_tpu/ops/pallas/fused_attention.py:ln_qkv_head_fused.
// Numerics follow it: LN statistics and affine in fp32, the LN output cast
// to the input dtype before the product, fp32 accumulation, the accumulator
// cast to the output dtype, and only then the bias added (in that dtype).
//
// Bound on the card: operations. At the whisper-small encoder shape
// (B*T = 2000 rows, D = 768, C = 2304) the product is 7.1 GFLOP against
// ~10 MB of traffic, ~700 flop/byte, above the H100's ~295 ridge; at one
// request (500 rows) it is 1.8 GFLOP, and a launch's latency counts as
// much as the operations. Two kernels, chosen on the host before the
// launch (ops/kernels/fused_attention.py:_plan):
//
// ln_qkv_head_mma_kernel<BM, 128> (bf16; D % 16 == 0, C % 8 == 0,
// Dh % 8 == 0, 16-byte-aligned x, weight and LN vectors): a block owns a
// BM x 128 output tile (csrc/mma_rows.cuh). It starts the cp.async copies
// of the first weight tiles, LayerNorms its BM rows of x in registers
// (16-byte loads, up to 8 rows a warp in flight, scale and bias staged in
// shared memory) into shared memory, rounded to bf16 (the rows never reach
// HBM; each column tile recomputes them), then streams the weight through
// a 3-stage ring of 32 x 128 tiles into mma.sync.m16n8k16 with fp32 sums.
// The epilogue rounds each sum to bf16, adds the bias in bf16, stages the
// tile through shared memory and stores 16-byte lines to (b, g, t, d), b
// and t derived per row (a tile may straddle batch rows). A plain launch,
// no split K and no atomics: repeats are bit-equal.
//
// What sets its pace (phase timestamps on an H100): the product is
// ldmatrix-bound at about half the time it takes, the rest being the ring's
// barrier per 32-deep stage; the LayerNorm, recomputed for every column
// tile, costs about as much as the product (it is issue-bound, ~8 fp32
// operations an element).
//
// ln_qkv_head_kernel<T> (fp32, and every other shape or alignment): the
// CUDA-core 32 x 128 row tile of row_tile.cuh with fp32 FMAs, as the port
// first wrote it; its results are unchanged.
#include "mma_rows.cuh"
#include "row_tile.cuh"

namespace {

using namespace row_tile;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_head_kernel(const T* __restrict__ x, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out, int rows,
                   int Tlen, int D, int C, int Dh, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;           // BM x D   normalised rows, rounded to T
  float* Ws = smem + BM * D;  // BK x BN  weight tile
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int G = C / Dh;

  layer_norm_rows(Hs, x, lns, lnb, row0, rows, D, eps);
  __syncthreads();
  float acc[4][4];
  product(Hs, Ws, w, D, C, n0, acc);

  // cast, bias in the output dtype, head-major store
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty * 4 + r;
    if (row >= rows) continue;
    const int b = row / Tlen, t = row % Tlen;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n >= C) continue;
      const float y = round_to<T>(acc[r][c]) + to_f32(bias[n]);
      const int g = n / Dh, d = n % Dh;
      out[((static_cast<size_t>(b) * G + g) * Tlen + t) * Dh + d] = from_f32<T>(y);
    }
  }
}

template <typename T>
int launch(const void* x, const void* lns, const void* lnb, const void* w,
           const void* bias, void* out, int B, int Tlen, int D, int C, int Dh,
           float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      ln_qkv_head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = B * Tlen;
  dim3 grid((C + BN - 1) / BN, (rows + BM - 1) / BM);
  ln_qkv_head_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), rows, Tlen, D, C, Dh, eps);
  return cudaGetLastError();
}


using mma_tile::bf16;

template <int BM, int BN>
__global__ void __launch_bounds__(mma_rows::Tile<BM, BN>::kThreads)
ln_qkv_head_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                       const float* __restrict__ lnb, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, bf16* __restrict__ out, int rows,
                       int Tlen, int D, int C, int Dh, float eps) {
  using TL = mma_rows::Tile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sb = reinterpret_cast<float*>(smem_raw);  // LN scale, then bias
  bf16* A = reinterpret_cast<bf16*>(sb + 2 * D);  // BM x (D + 8): the rows, LayerNorm'd
  bf16* ring = A + BM * (D + 8);
  const int row0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  mma_rows::prefetch<BM, BN>(ring, w, D, C, n0);
  mma_rows::layer_norm_rows<BM, TL::kThreads>(A, sb, x, row0, rows, D, lns, lnb, eps);
  float acc[2][TL::kNT][4];
  mma_rows::product<BM, BN>(acc, A, D, ring, w, C, n0);

  // sum rounded to bf16, + bias in bf16, staged as a BM x BN tile (pitch
  // BN + 8) in the shared memory the product has released
  bf16* st = A;
  constexpr int SP = BN + 8;
#pragma unroll
  for (int nt = 0; nt < TL::kNT; ++nt) {
    const int c = mma_rows::acc_col<BM, BN>(nt, 0), n = n0 + c;
    const float b0 = n < C ? __bfloat162float(bias[n]) : 0.f;  // C % 8 == 0: n + 1 < C too
    const float b1 = n < C ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mma_rows::acc_row<BM, BN>(mt, 2 * h);
        *reinterpret_cast<uint32_t*>(st + r * SP + c) =
            mma_tile::pack_bf16(round_to<bf16>(acc[mt][nt][2 * h]) + b0,
                                round_to<bf16>(acc[mt][nt][2 * h + 1]) + b1);
      }
  }
  __syncthreads();
  // 16-byte lines to (b, g, t, d): Dh % 8 == 0, so a line lies in one head;
  // b and t are derived per row (a tile may straddle batch rows)
  constexpr int kPieces = BN / 8;
  const int G = C / Dh;
#pragma unroll
  for (int i = 0; i < BM * kPieces / TL::kThreads; ++i) {
    const int e = threadIdx.x + i * TL::kThreads, r = e / kPieces, c = e % kPieces;
    const int row = row0 + r, n = n0 + c * 8;
    if (row >= rows || n >= C) continue;
    const int b = row / Tlen, t = row - b * Tlen, g = n / Dh, d = n - g * Dh;
    *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * G + g) * Tlen + t) * Dh + d) =
        *reinterpret_cast<const uint4*>(st + r * SP + c * 8);
  }
}

template <int BM, int BN>
int launch_mma(const void* x, const void* lns, const void* lnb, const void* w, const void* bias,
               void* out, int B, int Tlen, int D, int C, int Dh, float eps, cudaStream_t stream) {
  const size_t smem = mma_rows::smem_bytes(BM, BN, D);
  cudaError_t e = cudaFuncSetAttribute(ln_qkv_head_mma_kernel<BM, BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int rows = B * Tlen;
  dim3 grid((C + BN - 1) / BN, (rows + BM - 1) / BM);
  ln_qkv_head_mma_kernel<BM, BN><<<grid, mma_rows::Tile<BM, BN>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(lns), static_cast<const float*>(lnb),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias), static_cast<bf16*>(out), rows,
      Tlen, D, C, Dh, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: (B, T, D); ln_scale, ln_bias: (D,) fp32; w: (D, C); bias: (C,);
// out: (B, C / Dh, T, Dh). x, w, bias and out share `dtype`.
UV_EXPORT int uv_ln_qkv_head(const void* x, const void* ln_scale,
                             const void* ln_bias, const void* w,
                             const void* bias, void* out, int B, int Tlen,
                             int D, int C, int Dh, float eps, int dtype,
                             void* stream) {
  // the row tile must fit the shared memory a block may use
  if (B <= 0 || Tlen <= 0 || D <= 0 || Dh <= 0 || C % Dh ||
      row_tile::smem_bytes(D) > row_tile::kMaxSmem)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == UV_F32)
    return launch<float>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  if (dtype == UV_BF16)
    return launch<__nv_bfloat16>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  return cudaErrorInvalidValue;
}

// The tensor-core kernel, bf16 only, with the BM x 128 tile the host's
// plan chose (BM 128, 64 or 32). Needs D % 16 == 0, D <= 2048, C % 8 == 0,
// Dh % 8 == 0 and 16-byte-aligned x, ln_scale, ln_bias, w and out; the
// bias may have any alignment.
UV_EXPORT int uv_ln_qkv_head_mma(const void* x, const void* ln_scale, const void* ln_bias,
                                 const void* w, const void* bias, void* out, int B, int Tlen,
                                 int D, int C, int Dh, float eps, int bm, void* stream) {
  constexpr int BN = 128;
  if (B <= 0 || Tlen <= 0 || D <= 0 || Dh <= 0 || C <= 0 || D % 16 || D > mma_rows::kMaxK ||
      C % 8 || Dh % 8 || C % Dh || mma_rows::smem_bytes(bm, BN, D) > mma_rows::kMaxSmem)
    return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(ln_scale) || !aligned16(ln_bias) || !aligned16(w) ||
      !aligned16(out))
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch_mma<128, BN>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  if (bm == 64)
    return launch_mma<64, BN>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  if (bm == 32)
    return launch_mma<32, BN>(x, ln_scale, ln_bias, w, bias, out, B, Tlen, D, C, Dh, eps, s);
  return cudaErrorInvalidValue;
}

UV_DEFINE_ERROR_STRING(uv_ln_qkv_head)
