// K1's top-k rounds on one row held by one warp, shared by K1 (topk.cu)
// and kernel (c) (inner_cem.cu): order keys, the sort of a lane's slots and
// one round of two warp reductions.  topk.cu's note has the design and the
// semantics: the lowest column wins a tie, -0.0 equals +0.0, NaN ranks as
// -inf, and once no lane above -inf is left every round emits column 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmd_topk {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNegInfKey = 0x007fffffu;  // order_key(-inf)
constexpr unsigned kPadKey = 0u;              // columns at or past the ranked width

// A non-NaN float mapped to an unsigned key in the same order (+0 and -0
// map alike, as they compare equal).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A lane's key of a ranked value: NaN ranks as -inf.
__device__ __forceinline__ unsigned rank_key(float v) {
  return isnan(v) ? kNegInfKey : order_key(v);
}

// A lane's slots as (order key, column), sorted by key, descending; a
// stable bubble network keeps the lower column first on a tie.
template <int kSlots>
__device__ __forceinline__ void sort_slots(unsigned (&key)[kSlots], unsigned (&col)[kSlots]) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i)
#pragma unroll
    for (int j = 0; j + 1 < kSlots - i; ++j) {
      const bool swap = key[j + 1] > key[j];
      const unsigned k0 = key[j], c0 = col[j];
      key[j] = swap ? key[j + 1] : k0;
      col[j] = swap ? col[j + 1] : c0;
      key[j + 1] = swap ? k0 : key[j + 1];
      col[j + 1] = swap ? c0 : col[j + 1];
    }
}

// One round on the warp's sorted slots: the max of the heads' keys, then
// the least column holding it; the winner leaves its lane's list (the
// Pallas kernel masks it to -inf instead).  Once only -inf lanes are left,
// masked winners among them, the lowest of them is column 0, which the
// round returns.  Every lane gets the winner.
template <int kSlots>
__device__ __forceinline__ int round_winner(unsigned (&key)[kSlots], unsigned (&col)[kSlots]) {
  const unsigned top = __reduce_max_sync(kFull, key[0]);
  const unsigned win = __reduce_min_sync(kFull, key[0] == top ? col[0] : 0xffffffffu);
  const bool pop = col[0] == win;
#pragma unroll
  for (int t = 0; t + 1 < kSlots; ++t) {
    key[t] = pop ? key[t + 1] : key[t];
    col[t] = pop ? col[t + 1] : col[t];
  }
  key[kSlots - 1] = pop ? kPadKey : key[kSlots - 1];
  return top > kNegInfKey ? static_cast<int>(win) : 0;
}

}  // namespace mmd_topk
