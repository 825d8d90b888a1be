// K3's row arithmetic, shared by K3 (topk_kernel.cu) and the "fused" form
// of kernel (c) (inner_cem_body.cuh), so that a row gives the same bits in
// both: the rounds under the Pallas body's rules, the sentinel row and the
// order of a row's sum.  topk_kernel.cu's note has the semantics: no NaN
// mask (a row with a NaN among its first M lanes emits the sentinel M every
// round, whose rows are zero rows), a winner masked by subtracting 3.0e38
// (an infinite lane wins every round), and E = exp(-D / sigma) by the IEEE
// quotient (ieee_div.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "topk_rounds.cuh"

namespace mmd_k3 {

constexpr float kMask = 3.0e38f;
// a warp's buffer of partial sums: a row's 32 lanes at this stride, a
// multiple of 4 for 16-byte reads whose rows start 4 banks apart
constexpr int kRedStride = 32 + 4;

// |beta| - 3.0e38 on an order key, as the Pallas body masks a winner
__device__ __forceinline__ unsigned masked_key(unsigned key) {
  const unsigned u = (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
  return mmd_topk::order_key(__uint_as_float(u) - kMask);
}

// The order keys of |x| of a lane's columns lane + 32 t of the row xr (-inf
// at and past M, and for the whole row when live is false); returns
// whether any of the row's first M lanes is NaN (every lane gets it).
template <int kSlots>
__device__ __forceinline__ bool row_keys(const float* xr, int M, int lane, bool live,
                                         unsigned (&key)[kSlots]) {
  bool nan_lane = false;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int col = lane + t * 32;
    float v = -INFINITY;  // below every real lane, masked or not
    if (live && col < M) {
      v = fabsf(xr[col]);
      nan_lane |= isnan(v);
    }
    key[t] = mmd_topk::order_key(v);
  }
  return __any_sync(mmd_topk::kFull, nan_lane);
}

// One round: the largest key, the lowest column holding it (the Pallas tie
// rule "first index with absb >= max"); the lane holding the winner masks
// it.  Every lane gets the winner.
template <int kSlots>
__device__ __forceinline__ unsigned round_winner(unsigned (&key)[kSlots], int lane) {
  unsigned bk = key[0];
  unsigned bi = lane;
#pragma unroll
  for (int t = 1; t < kSlots; ++t)
    if (key[t] > bk) {  // the lower column wins a tie
      bk = key[t];
      bi = lane + t * 32;
    }
  const unsigned top = __reduce_max_sync(mmd_topk::kFull, bk);
  const unsigned win = __reduce_min_sync(mmd_topk::kFull, bk == top ? bi : 0xffffffffu);
  // its slot is the same for the whole warp: one branch, a predicated mask
  if (lane == static_cast<int>(win % 32)) {
    const int slot = static_cast<int>(win / 32);
#pragma unroll
    for (int t = 0; t < kSlots; ++t)
      if (t == slot) key[t] = masked_key(key[t]);
  }
  return win;
}

// A lane's partial sum of a selected row's values at its columns (0 past M)
template <int kSlots>
__device__ __forceinline__ float lane_partial(const float (&e)[kSlots]) {
  float part = 0.0f;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) part = __fadd_rn(part, e[t]);
  return part;
}

// The row's sum from its 32 lanes' partials, red[0 ... 31], read 16 bytes
// at a time: partials i, i + 4, ... 28 + i into accumulator i in order, then
// (acc0 + acc1) + (acc2 + acc3).
__device__ __forceinline__ float partials_sum(const float* red) {
  const float4* rr = reinterpret_cast<const float4*>(red);
  float4 acc = rr[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    const float4 q = rr[i];
    acc.x = __fadd_rn(acc.x, q.x);
    acc.y = __fadd_rn(acc.y, q.y);
    acc.z = __fadd_rn(acc.z, q.z);
    acc.w = __fadd_rn(acc.w, q.w);
  }
  return __fadd_rn(__fadd_rn(acc.x, acc.y), __fadd_rn(acc.z, acc.w));
}

}  // namespace mmd_k3
