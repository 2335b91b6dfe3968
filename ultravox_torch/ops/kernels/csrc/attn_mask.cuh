// The attention masks of the port's tensor-core kernels, computed from
// scalars: key j is hidden from a query row (its absolute position) when
// j >= lengths[b], when causal and j > row or (window > 0 and row - j >=
// window), or when j / latency_block > row / latency_block. Shared by
// flash_attention.cu and attention_mma.cuh.
//
// The mask of one element is an interval of keys per row (Span), tested
// with two compares against registers (Local); a tile that the mask leaves
// whole (tile_open) skips even those, and a block visits only the key
// tiles that some of its rows can see (key_range). No division by the
// latency block per element.
#pragma once

#include <limits.h>

namespace attn_mask {

constexpr float kNegInf = -0.7f * 3.402823466e38f;  // finite mask value

struct Mask {
  int S, len, causal, window, lb;
  __device__ bool hidden(int row, int col) const {
    return col >= len || (causal && (col > row || (window > 0 && row - col >= window))) ||
           (lb > 0 && col / lb > row / lb);
  }
};

// Keys [lo, hi) hold every key that some row of [q0, q1) can see; `full`
// says some row of it sees none (it then averages over all S keys).
struct Range {
  int lo, hi;
  bool full;
};

__device__ __forceinline__ Range key_range(const Mask& m, int q0, int q1) {
  const int last = q1 - 1;
  Range r{0, min(m.S, m.len), false};
  if (m.causal) {
    r.hi = min(r.hi, last + 1);
    if (m.window > 0) r.lo = max(0, q0 - m.window + 1);
  }
  if (m.lb > 0) r.hi = min(r.hi, (last / m.lb + 1) * m.lb);
  r.full = m.len <= 0 || (m.causal && m.window > 0 && last - (m.len - 1) >= m.window);
  return r;
}

// The mask hides no pair of the TQ rows from q0 and the TK keys from k0,
// so the tile needs no per-element mask. Keys past S are left to each
// kernel (keys_in_range).
template <int TQ, int TK>
__device__ __forceinline__ bool tile_open(const Mask& m, int q0, int k0) {
  const int q1 = q0 + TQ - 1, k1 = k0 + TK - 1;
  if (k1 >= m.len) return false;
  if (m.causal && (k1 > q0 || (m.window > 0 && q1 - k0 >= m.window))) return false;
  return !(m.lb > 0 && k1 / m.lb > q0 / m.lb);
}

template <int TK>
__device__ __forceinline__ bool keys_in_range(const Mask& m, int k0) { return k0 + TK <= m.S; }

// Mask::hidden as an interval: the keys [lo, hi) that a query row sees, or
// the query rows [lo, hi) that see a key. Computed once per row or key, so
// the per-element mask is two compares (no division by the latency block).
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span row_span(const Mask& m, int row) {
  Span s{0, m.len};
  if (m.causal) {
    s.hi = min(s.hi, row + 1);
    if (m.window > 0) s.lo = max(0, row - m.window + 1);
  }
  if (m.lb > 0) s.hi = min(s.hi, (row / m.lb + 1) * m.lb);
  return s;
}

__device__ __forceinline__ Span key_span(const Mask& m, int col) {
  if (col >= m.len) return Span{0, 0};
  Span s{0, INT_MAX};
  if (m.causal) {
    s.lo = col;
    if (m.window > 0) s.hi = col + m.window;
  }
  if (m.lb > 0) s.lo = max(s.lo, (col / m.lb) * m.lb);
  return s;
}

// A Span relative to this lane's first column (or row) of a tile at x0, so
// that the element at offset 8 n + c (c = 0, 1) is tested against two
// registers with an immediate: the mask in the fewest instructions.
struct Local {
  int lo, hi;
  __device__ bool hides(int x) const { return x < lo || x >= hi; }
};

__device__ __forceinline__ Local local(const Span& s, int x0) {
  const int base = x0 + 2 * (threadIdx.x & 3);
  return Local{s.lo - base, s.hi - base};
}

// The scaled logit from the product s, as the reference: NEG_INF where
// hidden; __fmul_rn so that no FMA contraction with a later subtraction
// rounds it differently in another pass or kernel.
__device__ __forceinline__ float logit(bool hidden, float s, float scale_log2e) {
  return hidden ? kNegInf : __fmul_rn(s, scale_log2e);
}

}  // namespace attn_mask
