// Kernel (f): the inner CEM's prologue, the refit of every candidate's
// mother rollouts and their distance matrices, in one launch an outer
// iteration.
//
// Replaces what XLA fuses from the JAX package's outer iteration before the
// inner beta-CEM (mpc_mmd_tpu/solver.py:218 refit_coefficients, qp.py:202;
// the L1 and squared L2 distances of select_reduced_set_batched,
// reduced_set.py:425-450), which the port ran as qp.refit_coefficients
// (two linalg.scenario_mm products a channel: batched cuBLAS GEMMs),
// torch.cat and kernels.pairwise_l1 / pairwise_l2sq: about a dozen
// launches an outer iteration, of which pairwise_l1 writes and reads its
// (C, M, M, 2 nvar) difference three times (56 MB a pass at fastrt, 445 MB
// at M = 225) to keep an (C, M, M) result.  Like kernels (a) to (e) it
// replaces an XLA lowering, not a Pallas kernel.
//
// Per candidate: its M rollouts x, y (M, T); per rollout and channel the
// refit c = (u @ P') @ Rinv^T, both products chains of fused multiply-adds
// from 0 in the order of the shared axis (what cuBLAS's FFMA kernels
// compute, as kernel (d) found for linalg.scenario_mm); the features f =
// [cx | cy] (F = 2 nvar); then every entry of
//   D[a, b] = sum_k |f[a, k] - f[b, k]|, each difference rounded on its
//     own, the sum in PyTorch's order for a contiguous row of F < 128
//     (torch_order.cuh);
//   D2[a, b] = max(aa[a] + aa[b] - 2 ab[a, b], 0) where the kernel reads
//     it (gaussian, matern52): aa the row sums of f f in the same order,
//     ab the batched matmul's chain of fused multiply-adds over k.
// Every elementwise step rounds on its own (__f*_rn), as PyTorch's kernels
// do, so that every output carries the plain chain's bits.  Both are
// symmetric bit for bit: |a - b| = |b - a| and the same order of the sum,
// aa[a] + aa[b] = aa[b] + aa[a], and a product's two factors commute in a
// fused multiply-add.
//
// What bounds it on the card: bytes.  At fastrt (64 candidates, M = 100,
// T = 50, nvar = 11) it reads 2.56 MB of rollouts and writes 0.56 MB of
// coefficients and 2.56 MB of D: 5.7 MB, 1.7 us at 3.35 TB/s (F15's 100 x
// 225 rollouts about 30 MB, 9 us).  Its work, 3 F operations an entry of
// D (and 5 F of D2), is 1.4e8 operations at fastrt, 2 us at 67 TFLOP/s.
//
// The design: a candidate is a thread-block cluster of cs = 1, 2 or 4 CTAs
// (the wrapper's launch_shape), and
// - each CTA stages its share of the candidate's rollouts (M / cs rows of
//   x and of y, contiguous in device memory) with two TMA bulk copies onto
//   an mbarrier, the head and tail floats outside whole 16-byte blocks by
//   its threads, no division an element;
// - each CTA refits its rows, once in the cluster, one or two threads a
//   (channel, rollout) with P's and Rinv's rows padded to 8-byte loads,
//   and writes
//   the features into every CTA's shared memory of the cluster
//   (distributed shared memory) and the coefficients to device memory;
// - after one cluster barrier the warps of the cluster share D's upper
//   block triangle in units of a 32-row block by 8 columns: a lane holds
//   its row's F features in registers, reads a column's as broadcast
//   16-byte loads from shared memory, takes the sum with the absolute
//   values folded into its adds, and writes both entries: D[b, a] with
//   the warp's 32 lanes on consecutive a (a 128-byte line), and D[a, b0 ..
//   b0 + 7] through the warp's buffer in shared memory, 8 lanes a row (a
//   32-byte sector each), so that each unordered pair is computed once
//   (twice within the 32 x 32 blocks on the diagonal) and every store
//   leaves as whole sectors.  Where M <= 32 (one row block: Path D, F5) a
//   thread of the cluster takes a pair a <= b and writes both entries, so
//   that the pairs spread over every warp, not over M / 8 units.
// The feature count is a compile-time constant at every path's nvar 11
// (F = 22); other nvar take the run-time instantiation, which reads both
// rows from shared memory.  (The earlier design: a candidate's rows of D over
// 2-5 CTAs, each of which staged all M rollouts by scalar loads with a
// division an element, refit all 2 M rows, and took each entry of D on
// its own; 16.7 us a launch at fastrt, 77.5 at F15: PERF.md.)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "torch_order.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNvar = 16;        // F = 2 nvar <= 32
constexpr int kPathF = 22;          // F at every path's nvar (11): compile time
constexpr int kChunk = 8;           // columns of D a unit
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The shared layout of a CTA, in floats: an mbarrier; the staged x and y
// rows (each region with room for the source's place in its 16-byte
// block), which the warps' row buffers of D (32 x 9 floats each) reuse
// once the refit is done; the features (M, fs); P (T, ps) and Rinv (nvar,
// ps), their rows padded to 4 floats; aa (M).
constexpr int kRowBuf = 32 * 9;

struct Layout {
  int rows, fs, ps, rsz, roll, f, p, r, aa, floats;
};

__host__ __device__ inline Layout layout(int M, int T, int nvar, int cs) {
  Layout L;
  L.rows = (M + cs - 1) / cs;
  L.fs = round4(2 * nvar);
  L.ps = round4(nvar);
  L.rsz = round4(L.rows * T + 4);
  L.roll = 4;
  L.f = L.roll + (2 * L.rsz > kWarps * kRowBuf ? 2 * L.rsz : kWarps * kRowBuf);
  L.p = L.f + M * L.fs;
  L.r = L.p + T * L.ps;
  L.aa = L.r + nvar * L.ps;
  L.floats = L.aa + round4(M);
  return L;
}

struct PrologueArgs {
  const float *xr, *yr, *P, *rinv;
  float *cx, *cy, *D, *D2;
  int M, T, nvar, cs;
};

// A barrier of the candidate's CTAs: the CTA's own where it is the whole
// cluster, else the cluster's, which orders the writes into other CTAs'
// shared memory before it (release) and after it (acquire), at cluster
// scope and no wider.
__device__ __forceinline__ void cluster_barrier(int cs) {
  if (cs == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// One step of the shuffle tree: partial x takes partial x + OFF, for a
// tree of W > OFF partials.
template <int OFF>
__device__ __forceinline__ void fold(float (&p)[32], int W) {
  if (OFF < W) {
#pragma unroll
    for (int x = 0; x < OFF; ++x) p[x] = __fadd_rn(p[x], p[x + OFF]);
  }
}

// PyTorch's sum of a contiguous row of n < 128 terms t(0) ... t(n-1)
// (torch_order.cuh's row_reduce at n < 128) in one thread: W =
// 2^floor(log2 n) partial sums, partial x adding terms x, x + W, x + 2W,
// x + 3W each into its own accumulator from 0, the four added in order,
// then the shuffle tree at offsets W / 2 ... 1.  N > 0 makes n a
// compile-time constant.
template <int N, class Get>
__device__ __forceinline__ float row_sum(Get t, int n_run) {
  const int n = N > 0 ? N : n_run;
  const int W = mmd_order::last_pow2(n);
  float p[32];  // registers: every index below is a constant once unrolled
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (x < W && x + i * W < n) a[i] = __fadd_rn(0.0f, t(x + i * W));
    p[x] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  }
  fold<16>(p, W);
  fold<8>(p, W);
  fold<4>(p, W);
  fold<2>(p, W);
  fold<1>(p, W);
  return p[0];
}

// row_sum<N> of |fa[k] - fb[k]| with the accumulators' additions of +0
// left out: every term is +0 or more (or NaN), to which adding +0 changes
// nothing, so the sum keeps row_sum's bits; the absolute values fold into
// the adds.
template <int N>
__device__ __forceinline__ float abs_sum(const float (&fa)[N], const float (&fb)[N]) {
  constexpr int W = mmd_order::last_pow2(N);
  float p[32];
#pragma unroll
  for (int x = 0; x < W; ++x) {
    float s = fabsf(__fsub_rn(fa[x], fb[x]));
#pragma unroll
    for (int i = 1; i < 4; ++i)
      if (x + i * W < N) s = __fadd_rn(s, fabsf(__fsub_rn(fa[x + i * W], fb[x + i * W])));
    p[x] = s;
  }
  fold<16>(p, W);
  fold<8>(p, W);
  fold<4>(p, W);
  fold<2>(p, W);
  fold<1>(p, W);
  return p[0];
}

// The refit of the CTA's 2 rows tasks (channel, rollout), G threads a task
// (G = 2 only where KF > 0): u_j = sum_k row[k] P[k, j], then c_i = sum_j
// u_j Rinv[i, j], each c to the coefficients and to the features of every
// CTA of the cluster.  Thread g of a task takes j, i in [g J, g J + J), J =
// ceil(nvar / G), and the pair swaps its u through one shuffle a value.
// KF > 0: P's and Rinv's padded rows read 8 bytes at a time.
template <int KF, int G>
__device__ __forceinline__ void refit(const PrologueArgs& a, const Layout& L,
                                      const float* roll_x, const float* roll_y, float* sm,
                                      cg::cluster_group& cluster, int b, int m0, int rows) {
  constexpr int NV = KF > 0 ? KF / 2 : kMaxNvar;
  constexpr int J = (NV + G - 1) / G;  // G = 2: even, the pad column past nvar
  const int nvar = KF > 0 ? KF / 2 : a.nvar, T = a.T;
  const int g = threadIdx.x % G, j0 = g * J;
  const unsigned pair_mask = G == 1 ? 1u : 3u << (threadIdx.x % 32 & ~1);
  const float* p_s = sm + L.p;
  const float* r_s = sm + L.r;
#pragma unroll 1
  for (int task = threadIdx.x / G; task < 2 * rows; task += kThreads / G) {
    const int ch = task >= rows ? 1 : 0, ml = task - ch * rows;
    const float* row = (ch == 0 ? roll_x : roll_y) + ml * T;
    float u[J];
#pragma unroll
    for (int j = 0; j < J; ++j) u[j] = 0.0f;
#pragma unroll 5
    for (int k = 0; k < T; ++k) {
      const float v = row[k];
      const float* pk = p_s + k * L.ps + j0;
      if constexpr (KF > 0) {
#pragma unroll
        for (int j = 0; j < J; j += 2) {
          const float2 w = *reinterpret_cast<const float2*>(pk + j);
          u[j] = __fmaf_rn(v, w.x, u[j]);
          if (j + 1 < J) u[j + 1] = __fmaf_rn(v, w.y, u[j + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (j < nvar) u[j] = __fmaf_rn(v, pk[j], u[j]);
      }
    }
    // the task's whole u in order: thread 0's block, then thread 1's
    float uu[G * J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (G == 1) {
        uu[j] = u[j];
      } else {
        const float other = __shfl_xor_sync(pair_mask, u[j], 1);
        uu[j] = g == 0 ? u[j] : other;
        uu[(G - 1) * J + j] = g == 0 ? other : u[j];
      }
    }
    const int m = m0 + ml;
    float* out = (ch == 0 ? a.cx : a.cy) + (static_cast<long long>(b) * a.M + m) * nvar;
    float* f = sm + L.f + m * L.fs + ch * nvar;
#pragma unroll 1
    for (int i = j0; i < min(nvar, j0 + J); ++i) {
      const float* ri = r_s + i * L.ps;
      float c = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (KF > 0 || j < nvar) c = __fmaf_rn(uu[j], ri[j], c);
      out[i] = c;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < a.cs) *cluster.map_shared_rank(f + i, r) = c;
    }
  }
}

// The warp's 32 x 8 entries (lane l: row a0 + l, its d[0 .. 7]) into
// out[a0 .. a0 + 31, b0 .. b0 + 7] through its buffer (32 rows of 9), read
// back a row's 8 entries to 8 neighbouring lanes.
__device__ __forceinline__ void row_segments(float* out, float* buf, const float (&d)[kChunk],
                                             long long base, int M, int a0, int b0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int q = 0; q < kChunk; ++q) buf[lane * 9 + q] = d[q];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32 * kChunk / 32; ++i) {
    const int r = i * 4 + lane / kChunk, q = lane % kChunk;
    if (a0 + r < M && b0 + q < M)
      out[base + static_cast<long long>(a0 + r) * M + b0 + q] = buf[r * 9 + q];
  }
  __syncwarp();
}

// A column's features as a lane's registers (KF > 0), from 16-byte loads.
template <int KF>
__device__ __forceinline__ void load_row(float (&f)[KF], const float* p) {
#pragma unroll
  for (int k = 0; k < KF; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + k);
    f[k] = v.x;
    f[k + 1] = v.y;
    if (k + 2 < KF) f[k + 2] = v.z;
    if (k + 3 < KF) f[k + 3] = v.w;
  }
}

// The entry of D (sum |fa - fb|) and of D2's ab (sum fa fb) of two rows of
// features, fap and fbp in shared memory (KF > 0: fa in registers).
template <int KF>
__device__ __forceinline__ float pair(const float (&fa)[KF > 0 ? KF : 1], const float* fap,
                                      const float* fbp, int F, bool d2, float& ab) {
  ab = 0.0f;
  if constexpr (KF > 0) {
    float fb[KF];
    load_row<KF>(fb, fbp);
    if (d2) {
#pragma unroll
      for (int k = 0; k < KF; ++k) ab = __fmaf_rn(fa[k], fb[k], ab);
    }
    return abs_sum<KF>(fa, fb);
  } else {
    if (d2) {
      for (int k = 0; k < F; ++k) ab = __fmaf_rn(fap[k], fbp[k], ab);
    }
    return row_sum<0>([=](int k) { return fabsf(__fsub_rn(fap[k], fbp[k])); }, F);
  }
}

// D2's entry from ab and the rows' aa
__device__ __forceinline__ float l2sq(const float* aa, int i, int j, float ab) {
  return mmd_order::clamp_min(__fsub_rn(__fadd_rn(aa[i], aa[j]), __fmul_rn(2.0f, ab)), 0.0f);
}

// One unit of D (and D2): the warp's 32 rows a = a0 + lane against the 8
// columns b0 ... b0 + 7; fa the lane's features (KF > 0: in registers),
// buf the warp's row buffer.
template <int KF>
__device__ __forceinline__ void unit(const PrologueArgs& a, const Layout& L, const float* sm,
                                     float* buf, const float (&fa)[KF > 0 ? KF : 1], int b,
                                     int row, int b0) {
  const int M = a.M, F = 2 * (KF > 0 ? KF / 2 : a.nvar);
  const float* f_s = sm + L.f;
  const float* aa = sm + L.aa;
  const bool live = row < M;
  const long long base = static_cast<long long>(b) * M * M;
  const float* fap = f_s + min(row, M - 1) * L.fs;
  float d[kChunk], d2[kChunk];
#pragma unroll
  for (int q = 0; q < kChunk; ++q) {
    const int col = min(b0 + q, M - 1);  // past M: column M - 1 again, not stored
    float ab;
    d[q] = pair<KF>(fa, fap, f_s + col * L.fs, F, a.D2 != nullptr, ab);
    const bool store = live && b0 + q < M;
    if (store) a.D[base + static_cast<long long>(col) * M + row] = d[q];
    if (a.D2 != nullptr) {
      d2[q] = l2sq(aa, min(row, M - 1), col, ab);
      if (store) a.D2[base + static_cast<long long>(col) * M + row] = d2[q];
    }
  }
  // the 32 rows' entries b0 ... b0 + 7 through the warp's buffer, each
  // store four rows' 32-byte segments
  row_segments(a.D, buf, d, base, M, row - threadIdx.x % 32, b0);
  if (a.D2 != nullptr) row_segments(a.D2, buf, d2, base, M, row - threadIdx.x % 32, b0);
}

// KF: the feature count F at compile time, or 0 (F = 2 nvar at run time)
template <int KF>
__global__ void __launch_bounds__(kThreads)
inner_prologue_kernel(const PrologueArgs a) {
  extern __shared__ __align__(16) float sm[];
  // ---- kf: begin
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / a.cs, tid = threadIdx.x;
  const int M = a.M, T = a.T, nvar = KF > 0 ? KF / 2 : a.nvar;
  const Layout L = layout(M, T, nvar, a.cs);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
  const int m0 = min(M, rank * L.rows), rows = min(M, m0 + L.rows) - m0;

  // staging: this CTA's rows of x and y, their whole 16-byte blocks by TMA
  const long long e0 = (static_cast<long long>(b) * M + m0) * T;
  const int n = rows * T;
  const float* src[2] = {a.xr + e0, a.yr + e0};
  float* dst[2];
  int head[2], body[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(src[ch]) >> 2) & 3);
    dst[ch] = sm + L.roll + ch * L.rsz + shift;
    head[ch] = min(n, (4 - shift) & 3);
    body[ch] = (n - head[ch]) & ~3;
  }
  if (tid == 0) {
    mmd_async::mbar_init(bar);
    mmd_async::mbar_fence_init();
    mmd_async::mbar_expect(bar, 4u * (body[0] + body[1]));
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
      if (body[ch] > 0)
        mmd_async::bulk_copy(dst[ch] + head[ch], src[ch] + head[ch], 4u * body[ch], bar);
  }
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    for (int e = tid; e < head[ch]; e += kThreads) dst[ch][e] = src[ch][e];
    for (int e = head[ch] + body[ch] + tid; e < n; e += kThreads) dst[ch][e] = src[ch][e];
  }
  for (int e = tid; e < T * nvar; e += kThreads) sm[L.p + e / nvar * L.ps + e % nvar] = a.P[e];
  for (int e = tid; e < nvar * nvar; e += kThreads)
    sm[L.r + e / nvar * L.ps + e % nvar] = a.rinv[e];
  // every CTA of the cluster running before any writes into another's
  // shared memory; the mbarrier's initialisation seen by every thread
  cluster_barrier(a.cs);
  mmd_async::mbar_wait(bar);

  // ---- kf: refit
  if (KF > 0 && 4 * rows <= kThreads)
    refit<KF, (KF > 0 ? 2 : 1)>(a, L, dst[0], dst[1], sm, cluster, b, m0, rows);
  else
    refit<KF, 1>(a, L, dst[0], dst[1], sm, cluster, b, m0, rows);
  // every CTA's features in place; no CTA writes another's shared memory
  // after this barrier
  cluster_barrier(a.cs);

  // ---- kf: aa
  if (a.D2 != nullptr) {
    const float* f_s = sm + L.f;
    for (int m = tid; m < M; m += kThreads) {
      const float* f = f_s + m * L.fs;
      sm[L.aa + m] = row_sum<KF>([=](int k) { return __fmul_rn(f[k], f[k]); }, 2 * nvar);
    }
    __syncthreads();
  }

  // ---- kf: D
  // units (row block I, column chunk c), b0 = 32 I + 8 c, in order, unit u
  // to the cluster's warp u % W
  const int lane = tid % 32, gw = rank * kWarps + tid / 32, W = a.cs * kWarps;
  float* buf = sm + L.roll + (tid / 32) * kRowBuf;  // the staged rows are spent
  if (M <= 32) {
    // one row block: a pair (a <= b) a thread of the cluster, both entries
    const long long base = static_cast<long long>(b) * M * M;
    const float* f_s = sm + L.f;
    for (int e = gw * 32 + lane; e < M * M; e += W * 32) {
      const int i = e / M, j = e - i * M;
      if (j < i) continue;
      float fa[KF > 0 ? KF : 1], ab;
      if constexpr (KF > 0) load_row<KF>(fa, f_s + i * L.fs);
      const float d = pair<KF>(fa, f_s + i * L.fs, f_s + j * L.fs, 2 * nvar,
                               a.D2 != nullptr, ab);
      a.D[base + static_cast<long long>(i) * M + j] = d;
      a.D[base + static_cast<long long>(j) * M + i] = d;
      if (a.D2 != nullptr) {
        const float d2 = l2sq(sm + L.aa, i, j, ab);
        a.D2[base + static_cast<long long>(i) * M + j] = d2;
        a.D2[base + static_cast<long long>(j) * M + i] = d2;
      }
    }
  }
  int u0 = 0;
  for (int a0 = 0; M > 32 && a0 < M; a0 += 32) {
    const int units = (M - a0 + kChunk - 1) / kChunk;
    int c = ((gw - u0) % W + W) % W;
    u0 += units;
    if (c >= units) continue;
    const int row = a0 + lane;
    float fa[KF > 0 ? KF : 1];
    if constexpr (KF > 0) load_row<KF>(fa, sm + L.f + min(row, M - 1) * L.fs);
    for (; c < units; c += W) unit<KF>(a, L, sm, buf, fa, b, row, a0 + kChunk * c);
  }
  // ---- kf: end
}

template <int KF>
int launch(const PrologueArgs& a, int B, size_t smem, cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(  // past 48 KB, once
      inner_prologue_kernel<KF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(B * a.cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, inner_prologue_kernel<KF>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The prologue of B candidates' M mother rollouts (B M, T): cx, cy (B, M,
// nvar), D (B, M, M) and, unless D2 is null, D2 (B, M, M).  P is (T, nvar),
// rinv (nvar, nvar).  A candidate is a cluster of `cluster` (1, 2 or 4)
// CTAs (ops/inner_prologue.py's launch_shape).
extern "C" int mmd_inner_prologue(const float* xr, const float* yr, const float* P,
                                  const float* rinv, float* cx, float* cy, float* D,
                                  float* D2, int B, int M, int T, int nvar, int cluster,
                                  void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (cluster != 1 && cluster != 2 && cluster != 4) return cudaErrorInvalidValue;
  if (nvar < 1 || nvar > kMaxNvar || T < 1 || static_cast<long long>(B) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = 4 * static_cast<size_t>(layout(M, T, nvar, cluster).floats);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const PrologueArgs a = {xr, yr, P, rinv, cx, cy, D, D2, M, T, nvar, cluster};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (2 * nvar == kPathF) return launch<kPathF>(a, B, smem, s);
  return launch<0>(a, B, smem, s);
}
