// PyTorch's orders of summation on the card (ATen's Reduce.cuh), for the
// kernels whose outputs must carry the bits of a plain chain of PyTorch
// operations: kernel (d) (outer_project.cu: its norms and the obstacle
// blocks' sums, unwrap's cumulative sum), kernel (e) (outer_tail.cu),
// kernel (c)'s "xt" form (inner_cem_body.cuh) and kernel (h)
// (local_frame.cu: the arc length's cumulative sum).  Every sum here adds terms that the chain rounds on
// their own (a product is an elementwise kernel before the sum), each
// accumulator starting from +0, with the IEEE add and no contraction; a
// 2-norm's terms are the fused squares of NormTwoOps.
//
// Which form a sum takes follows the memory layout TensorIterator gives
// the tensor it reduces: an axis of stride 1 is reduced as a row, any
// other axis one thread an output.
//
// A reduction along the contiguous axis of a row of n < 128 floats takes
// W = 2^floor(log2 n) (at most 32) threads, thread x putting terms x, x + W,
// x + 2W, x + 3W each into an accumulator of its own (four, vt0), added in
// order, then shuffles down at offsets W/2, W/4, ... 1.  From n = 128 on the
// row is read in 4-float vectors from its first 16-byte aligned element:
// the elements before it one a thread (threads shift ... 3) into the first
// accumulator, the vectors v = x, x + W, ... of thread x (W =
// 2^floor(log2(n / 4)), at most 32) element i into accumulator i, the
// elements after the last whole vector one a thread into the first, the
// four accumulators added in order, then the same shuffles.  A reduction
// along a strided axis (the output's axis is the fastest) takes one thread
// an output, term k into accumulator k % 4, the four added in order.
// kernel (c) (inner_cem.cu) checked the first two forms bit for bit
// against PyTorch on the H100, kernel (e) the third (and kernel (c)'s "xt"
// form its cost's two k-term sums, which take it).
//
// torch.cumsum takes one of two orders on the card (ATen's ScanUtils.cuh
// scan_dim).  The rows of a tensor of several rows are scanned by
// scan_innermost_dim: blocks of cumsum_block(rows, n) columns, a block's
// first element plus the total of the blocks before it, then Sklansky's
// levels (scan_innermost; kernel (d) checked it bit for bit).  A 1-d
// tensor goes to CUB's DeviceScan::InclusiveScan instead (cub_cumsum;
// CUB 2.8.2 in PyTorch 2.11 for CUDA 12.8, its float policy of sm_90,
// found by probing the H100 and checked bit for bit by kernel (h)).

#pragma once

#include <cuda_runtime.h>

namespace mmd_order {

constexpr unsigned kFull = 0xffffffffu;

// 2^floor(log2 n), at most 32 (a warp)
__host__ __device__ constexpr int last_pow2(int n) {
  return n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

// a sum's reduce step, and a 2-norm's (NormTwoOps: acc + v * v, contracted)
struct Add {
  __device__ float operator()(float acc, float v) const { return __fadd_rn(acc, v); }
};
struct Square {
  __device__ float operator()(float acc, float v) const { return __fmaf_rn(v, v, acc); }
};

// The reduction of the n floats t(0) ... t(n-1) of one row along the
// contiguous axis, by one warp, for a row whose first element lies `shift`
// floats past a 16-byte boundary in the plain chain's tensor.  Every lane
// gets the result.
template <class Op, class Get>
__device__ __forceinline__ float row_reduce(Get t, int n, int shift, Op op, int lane) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int W;
  if (n >= 128) {
    int h = 0;
    if (shift > 0) {
      h = 4 - shift;
      if (lane >= shift && lane < 4) a[0] = op(0.0f, t(lane - shift));
    }
    const int L = n - h, nvec = L / 4;
    W = last_pow2(n / 4);
    if (lane < W)
      for (int v = lane; v < nvec; v += W)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = op(a[i], t(h + 4 * v + i));
    if (lane < L % 4) a[0] = op(a[0], t(h + 4 * nvec + lane));
  } else {
    W = last_pow2(n);
    if (lane < W)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane + i * W < n) a[i] = op(0.0f, t(lane + i * W));
  }
  float p = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  for (int off = W / 2; off > 0; off >>= 1) p = __fadd_rn(p, __shfl_down_sync(kFull, p, off));
  return __shfl_sync(kFull, p, 0);
}

// The same reduction of n < 32 terms t(0) ... t(n-1) in one thread.
template <class Op, class Get>
__device__ __forceinline__ float small_reduce(Get t, int n, Op op) {
  const int W = last_pow2(n);
  float p[16];
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    if (x >= W) break;
    float a0 = op(0.0f, t(x));
    if (x + W < n) a0 = __fadd_rn(a0, op(0.0f, t(x + W)));
    p[x] = a0;
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int x = 0; x < off; ++x)
      if (off < W) p[x] = __fadd_rn(p[x], p[x + off]);
  return p[0];
}

// The reduction of K terms t(0) ... t(K-1) along a strided axis: term k
// into accumulator k % 4, the four added in order.
template <class Get>
__device__ __forceinline__ float strided_sum(Get t, int K) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int k = 0;
  for (; k + 3 < K; k += 4) {
    a0 = __fadd_rn(a0, t(k));
    a1 = __fadd_rn(a1, t(k + 1));
    a2 = __fadd_rn(a2, t(k + 2));
    a3 = __fadd_rn(a3, t(k + 3));
  }
  if (k < K) a0 = __fadd_rn(a0, t(k));
  if (k + 1 < K) a1 = __fadd_rn(a1, t(k + 1));
  if (k + 2 < K) a2 = __fadd_rn(a2, t(k + 2));
  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
}

// The same order for N terms held in registers (N a compile-time
// constant): kernel (c)'s "xt" form, whose cost sums a (k, rows) tensor
// along its first axis
template <int N>
__device__ __forceinline__ float strided_sum(const float (&v)[N]) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i % 4] = __fadd_rn(acc[i % 4], v[i]);
  return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
}

// torch.cumsum's block of columns for a (rows, n) tensor along its rows:
// 2 X, log2 X as ATen's get_log_num_threads_x_inner_scan takes it (in
// unsigned arithmetic, as ATen does)
__host__ __device__ inline int cumsum_block(unsigned rows, unsigned n) {
  unsigned lx = 0, ly = 0;
  while ((1u << lx) < n) ++lx;
  while ((1u << ly) < rows) ++ly;
  lx = (9u + (lx - ly)) / 2u;
  lx = lx < 4u ? 4u : lx > 9u ? 9u : lx;
  return 2 << lx;
}

// Sklansky's inclusive scan of the CHUNKS chunks v (element lane + 32 j
// of the row in v[j] of lane `lane`) in blocks of PER chunks: a block's
// first element plus the last element of the block before it, then the
// levels s = 1, 2, ... within the block (an element with bit s of its
// place adds the last element of the half below it), level by level as
// ATen's scan_innermost_dim runs them
template <int CHUNKS, int PER>
__device__ __forceinline__ void sklansky(float (&v)[CHUNKS], int lane) {
#pragma unroll
  for (int j0 = 0; j0 < CHUNKS; j0 += PER) {
    if (j0 > 0) {
      const float total = __shfl_sync(kFull, v[j0 - 1], 31);
      if (lane == 0) v[j0] = __fadd_rn(v[j0], total);
    }
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1)
#pragma unroll
      for (int j = j0; j < j0 + PER && j < CHUNKS; ++j) {
        const float o = __shfl_sync(kFull, v[j], (lane & ~(2 * sh - 1)) + sh - 1);
        if (lane & sh) v[j] = __fadd_rn(v[j], o);
      }
#pragma unroll
    for (int sc = 1; sc < PER; sc <<= 1)  // the levels of 32 sc elements
#pragma unroll
      for (int j = j0; j < j0 + PER && j < CHUNKS; ++j)
        if ((j - j0) & sc) {
          const int src = j0 + ((j - j0) & ~(2 * sc - 1)) + sc - 1;
          v[j] = __fadd_rn(v[j], __shfl_sync(kFull, v[src], 31));
        }
  }
}

// The inclusive scan of a row of up to 32 CHUNKS elements in chunks v (as
// sklansky's) in torch.cumsum's order for the rows of a (rows, n) tensor:
// blocks of B = cumsum_block(rows, n) columns, by one warp
template <int CHUNKS>
__device__ __forceinline__ void scan_innermost(float (&v)[CHUNKS], int B, int lane) {
  switch (B) {
    case 32: sklansky<CHUNKS, 1>(v, lane); break;
    case 64: sklansky<CHUNKS, 2>(v, lane); break;
    case 128: sklansky<CHUNKS, 4>(v, lane); break;
    case 256: sklansky<CHUNKS, 8>(v, lane); break;
    case 512: sklansky<CHUNKS, 16>(v, lane); break;
    default: sklansky<CHUNKS, 32>(v, lane);
  }
}

// CUB's items a thread in torch.cumsum's scan of a 1-d float tensor
constexpr int kCubItems = 15;

// out[0 .. n) the inclusive cumulative sum of in[0 .. n) in torch.cumsum's
// order for a 1-d tensor on the card (CUB's DeviceScan, one tile): thread
// t of the first W warps takes items 15 t ... 15 t + 14 (past n the first
// item again, as CUB pads a tile), sums them in order from its first, and
// the warp scans those sums (Kogge-Stone: at offsets 1, 2, ... 16 a lane
// adds the lower lane's partial); the warps' totals are added in order,
// each warp's prefix the sum before it; a thread's exclusive prefix is its
// warp's prefix plus the lane below's scan (thread 0 has none), and its
// outputs its items added in turn to it.  n <= 480 W.  Every thread of
// the block calls it (a __syncthreads inside); `total` holds W floats of
// shared memory.  CUB's tile of sm_90 holds more than 960 items, so at
// W <= 2 the one-tile order is the order of every tile (a later tile's
// prefix is the tiles' totals added in turn, as the warps' are).
template <int W>
__device__ void cub_cumsum(const float* in, float* out, int n, float* total) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool scans = warp < W;
  const int base = kCubItems * tid;
  float v[kCubItems], scan = 0.0f, below = 0.0f;
  if (scans) {
#pragma unroll
    for (int i = 0; i < kCubItems; ++i) v[i] = base + i < n ? in[base + i] : in[0];
    float sum = v[0];
#pragma unroll
    for (int i = 1; i < kCubItems; ++i) sum = __fadd_rn(sum, v[i]);
    scan = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float lower = __shfl_up_sync(kFull, scan, off);
      if (lane >= off) scan = __fadd_rn(lower, scan);
    }
    below = __shfl_up_sync(kFull, scan, 1);
    if (lane == 31) total[warp] = scan;
  }
  __syncthreads();
  if (!scans || base >= n) return;
  float prefix = below, block = total[0];
#pragma unroll
  for (int w = 1; w < W; ++w) {
    if (warp == w) prefix = lane == 0 ? block : __fadd_rn(block, below);
    block = __fadd_rn(block, total[w]);
  }
  float run = tid == 0 ? v[0] : __fadd_rn(prefix, v[0]);
  out[base] = run;
#pragma unroll
  for (int i = 1; i < kCubItems; ++i) {
    run = __fadd_rn(run, v[i]);
    if (base + i < n) out[base + i] = run;
  }
}

// PyTorch's clamp on the card: NaN stays NaN, else min(max(v, lo), hi)
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
// torch.minimum: a NaN operand wins
__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
// torch.maximum, and torch.clamp with a tensor min: a NaN operand wins
__device__ __forceinline__ float maximum(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

}  // namespace mmd_order
