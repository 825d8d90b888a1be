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
// Per candidate: its M rollouts x, y (M, T) staged in shared memory; per
// rollout and channel the refit c = (u @ P') @ Rinv^T, both products
// chains of fused multiply-adds from 0 in the order of the shared axis
// (what cuBLAS's FFMA kernels compute, as kernel (d) found for
// linalg.scenario_mm); the features f = [cx | cy] (F = 2 nvar) in shared
// memory; then every entry of
//   D[a, b] = sum_k |f[a, k] - f[b, k]|, each difference rounded on its
//     own, the sum in PyTorch's order for a contiguous row of F < 128
//     (torch_order.cuh);
//   D2[a, b] = max(aa[a] + aa[b] - 2 ab[a, b], 0) where the kernel reads
//     it (gaussian, matern52): aa the row sums of f f in the same order,
//     ab the batched matmul's chain of fused multiply-adds over k.
// Every elementwise step rounds on its own (__f*_rn), as PyTorch's kernels
// do, so that every output carries the plain chain's bits.
//
// What bounds it on the card: bytes.  At fastrt (64 candidates, M = 100,
// T = 50, nvar = 11) it reads 2.56 MB of rollouts and writes 0.56 MB of
// coefficients and 2.56 MB of D: 5.7 MB, 1.7 us at 3.35 TB/s (F15's 100 x
// 225 rollouts about 30 MB, 9 us).  Its work, 3 F operations an entry of
// D (and 5 F of D2), is 1.4e8 operations at fastrt, 2 us at 67 TFLOP/s.
// The design keeps everything but the outputs in shared memory: the
// rollouts (the row stride T rounded up to odd, so that a warp's rows fall
// in distinct banks), the two matrices and the features (stride F + 1);
// each entry of D is one thread's loop, the threads of a warp on
// neighbouring b, so the stores are whole lines.  What set its time was
// the instructions of that loop: the feature count is a compile-time
// constant at every path's nvar 11 (F = 22), so that the sum's order
// unrolls into its 22 differences and 21 additions with no bound checks,
// its partial sums in registers; other nvar take the run-time
// instantiation of the same code.  A candidate's rows of D are split over
// `splits` CTAs (the wrapper picks enough to put two CTAs on every SM),
// each of which refits all M rollouts (its columns) and writes its own
// rows.  (A CTA a candidate with the run-time feature count took 80 us a
// launch at fastrt, its rows over 5 CTAs 50 us, and over a thread-block
// cluster that shared the refit through distributed shared memory 61 us:
// PERF.md §6.)

#include <cuda_runtime.h>
#include <math.h>

#include "torch_order.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxNvar = 16;        // F = 2 nvar <= 32
constexpr int kPathF = 22;          // F at every path's nvar (11): compile time
constexpr size_t kMaxSmem = 227 * 1024;

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

// KF: the feature count F at compile time, or 0 (F = 2 nvar at run time)
template <int KF>
__global__ void __launch_bounds__(kThreads)
inner_prologue_kernel(const float* __restrict__ xr, const float* __restrict__ yr,
                      const float* __restrict__ P, const float* __restrict__ rinv,
                      float* __restrict__ cx, float* __restrict__ cy,
                      float* __restrict__ D, float* __restrict__ D2, int M, int T,
                      int nvar_run, int rows_per_cta) {
  extern __shared__ float sm[];
  const int nvar = KF > 0 ? KF / 2 : nvar_run;
  const int ts = T | 1, F = 2 * nvar, fs = F + 1;
  float* roll = sm;                       // (2, M, ts): x rows, then y rows
  float* p_s = roll + 2 * M * ts;         // (T, nvar)
  float* r_s = p_s + T * nvar;            // (nvar, nvar)
  float* f_s = r_s + nvar * nvar;         // (M, fs): [cx | cy]
  float* aa = f_s + M * fs;               // (M,)
  const int b = blockIdx.x, tid = threadIdx.x;
  // this CTA's rows of D (and of cx, cy)
  const int r0 = blockIdx.y * rows_per_cta, r1 = min(M, r0 + rows_per_cta);
  const long long base = static_cast<long long>(b) * M * T;
  for (int e = tid; e < M * T; e += kThreads) {
    const int m = e / T, t = e - m * T;
    roll[m * ts + t] = xr[base + e];
    roll[(M + m) * ts + t] = yr[base + e];
  }
  for (int e = tid; e < T * nvar; e += kThreads) p_s[e] = P[e];
  for (int e = tid; e < nvar * nvar; e += kThreads) r_s[e] = rinv[e];
  __syncthreads();

  // the refit of rollout m of channel ch (0: x, 1: y)
  for (int task = tid; task < 2 * M; task += kThreads) {
    const int ch = task / M, m = task - ch * M;
    const float* row = roll + (ch * M + m) * ts;
    float u[kMaxNvar];
#pragma unroll
    for (int j = 0; j < kMaxNvar; ++j) u[j] = 0.0f;
    for (int k = 0; k < T; ++k) {
      const float v = row[k];
#pragma unroll
      for (int j = 0; j < kMaxNvar; ++j)
        if (j < nvar) u[j] = __fmaf_rn(v, p_s[k * nvar + j], u[j]);
    }
    float* out = (ch == 0 ? cx : cy) + (static_cast<long long>(b) * M + m) * nvar;
    const bool mine = m >= r0 && m < r1;
#pragma unroll
    for (int i = 0; i < kMaxNvar; ++i) {
      if (i < nvar) {
        float c = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxNvar; ++j)
          if (j < nvar) c = __fmaf_rn(u[j], r_s[i * nvar + j], c);
        if (mine) out[i] = c;
        f_s[m * fs + ch * nvar + i] = c;
      }
    }
  }
  __syncthreads();
  if (D2 != nullptr) {
    for (int m = tid; m < M; m += kThreads) {
      const float* f = f_s + m * fs;
      aa[m] = row_sum<KF>([=](int k) { return __fmul_rn(f[k], f[k]); }, F);
    }
    __syncthreads();
  }

  const long long out0 = static_cast<long long>(b) * M * M + static_cast<long long>(r0) * M;
  for (int e = tid; e < (r1 - r0) * M; e += kThreads) {
    const int i = r0 + e / M, j = e % M;
    const float* fa = f_s + i * fs;
    const float* fb = f_s + j * fs;
    D[out0 + e] = row_sum<KF>([=](int k) { return fabsf(__fsub_rn(fa[k], fb[k])); }, F);
    if (D2 != nullptr) {
      float ab = 0.0f;
#pragma unroll
      for (int k = 0; k < 2 * kMaxNvar; ++k)
        if (k < F) ab = __fmaf_rn(fa[k], fb[k], ab);
      D2[out0 + e] = mmd_order::clamp_min(
          __fsub_rn(__fadd_rn(aa[i], aa[j]), __fmul_rn(2.0f, ab)), 0.0f);
    }
  }
}

size_t smem_bytes(int M, int T, int nvar) {
  const int F = 2 * nvar;
  return sizeof(float) * (2 * static_cast<size_t>(M) * (T | 1) + T * nvar + nvar * nvar
                          + static_cast<size_t>(M) * (F + 1) + M);
}

template <int KF>
int launch(const float* xr, const float* yr, const float* P, const float* rinv, float* cx,
           float* cy, float* D, float* D2, int B, int M, int T, int nvar, int rows,
           size_t smem, cudaStream_t stream) {
  static bool opted = false;  // past the 48 KB default, once an instantiation
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        inner_prologue_kernel<KF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  inner_prologue_kernel<KF><<<dim3(B, (M + rows - 1) / rows), kThreads, smem, stream>>>(
      xr, yr, P, rinv, cx, cy, D, D2, M, T, nvar, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The prologue of B candidates' M mother rollouts (B M, T): cx, cy (B, M,
// nvar), D (B, M, M) and, unless D2 is null, D2 (B, M, M).  P is (T, nvar),
// rinv (nvar, nvar).  Each candidate's rows go to `splits` CTAs.
extern "C" int mmd_inner_prologue(const float* xr, const float* yr, const float* P,
                                  const float* rinv, float* cx, float* cy, float* D,
                                  float* D2, int B, int M, int T, int nvar, int splits,
                                  void* stream) {
  if (B <= 0 || M <= 0) return 0;
  if (splits < 1 || splits > M || splits > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, T, nvar);
  if (nvar < 1 || nvar > kMaxNvar || T < 1 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const int rows = (M + splits - 1) / splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (2 * nvar == kPathF)
    return launch<kPathF>(xr, yr, P, rinv, cx, cy, D, D2, B, M, T, nvar, rows, smem, s);
  return launch<0>(xr, yr, P, rinv, cx, cy, D, D2, B, M, T, nvar, rows, smem, s);
}
