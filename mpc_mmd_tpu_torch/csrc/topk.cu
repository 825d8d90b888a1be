// K1: row-wise top-k indices, one warp per row.
//
// Replaces the TPU kernel mpc_mmd_tpu/ops/topk_pallas.py::topk_indices_pallas
// (pl.pallas_call at topk_pallas.py:116), which runs k max-and-mask rounds per
// row block in VMEM.
//
// Semantics (identical to the Pallas kernel and lax.top_k on NaN-free rows):
// indices of the k largest values in descending order; equal values go to
// the lowest index; NaN is mapped to -inf before the first round, so a NaN
// lane never wins while a finite lane remains, and an all-NaN row emits
// index 0 k times (each round's winner is masked to -inf and the lowest
// index wins the tie among -inf lanes).  With `absolute` the ranking key is
// |x|; only the first `m` of the row's `width` lanes are ranked.
//
// What bounds it on the card: at the main path's shape (3648 rows of 101
// floats, k = 10) the kernel reads 1.5 MB and writes 146 KB, microseconds of
// HBM time; the cost is the k dependent rounds of a 5-step warp shuffle,
// i.e. latency, and the launch itself.  The design keeps a row in
// registers (at most 4 values per lane, coalesced loads: lane l holds
// columns l, l+32, l+64, l+96), so every round is register work plus
// shuffles and the row is read from memory once.  Rows wider than 128 are
// refused by the wrapper.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPerLane = 4;           // width <= 128
constexpr int kWarpsPerBlock = 4;

// (v, i) beats (v2, i2) when v is larger, or equal with the lower index.
__device__ __forceinline__ bool better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

__global__ void topk_kernel(const float* __restrict__ x, int* __restrict__ out,
                            int rows, int width, int m, int k, int absolute) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warp leaves together

  const float* xr = x + static_cast<long long>(row) * width;
  float v[kPerLane];
  int idx[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + j * kWarp;
    idx[j] = c;
    float val = -INFINITY;
    if (c < m) {
      val = xr[c];
      if (absolute) val = fabsf(val);
      if (isnan(val)) val = -INFINITY;
    } else {
      idx[j] = 1 << 30;  // never beats a real lane on a tie
    }
    v[j] = val;
  }

  for (int round = 0; round < k; ++round) {
    float bv = v[0];
    int bi = idx[0];
#pragma unroll
    for (int j = 1; j < kPerLane; ++j)
      if (better(v[j], idx[j], bv, bi)) { bv = v[j]; bi = idx[j]; }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    // every lane now holds the winner; its owner masks it out
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (idx[j] == bi) v[j] = -INFINITY;
    if (lane == 0) out[static_cast<long long>(row) * k + round] = bi;
  }
}

}  // namespace

extern "C" int mmd_topk_indices(const float* x, int* out, int rows, int width,
                                int m, int k, int absolute, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  topk_kernel<<<blocks, kWarpsPerBlock * kWarp, 0,
                static_cast<cudaStream_t>(stream)>>>(x, out, rows, width, m, k,
                                                     absolute);
  return static_cast<int>(cudaGetLastError());
}
