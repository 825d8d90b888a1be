// Kernel (c): the inner beta-CEM of every candidate, every iteration in one
// launch, for the "xla" selection with elite-carry.
//
// Replaces what XLA compiles from the JAX package's lax.scan over the inner
// iterations (mpc_mmd_tpu/reduced_set.py:622-717: _selection_qp at :487,
// _update_samples at :575, _winner at :595), which the port ran as a
// Python loop of about 45-50 PyTorch launches an iteration (the chain that
// ops/inner_cem.py keeps as the plain version).  Like draw kernels (a) and
// (b) it replaces an XLA lowering, not a Pallas kernel; inside it run
// K1's top-k rounds (topk_rounds.cuh), K3's division (ieee_div.cuh) and
// K2's solve of one system (qp_system.cuh).
//
// Per candidate c, with D[c] (M x M; D2[c] beside it for the gaussian and
// matern52 kernels), the shared first batch samples0 (S, M+1), the affine
// resample's A_all (maxiter, S', n_el) and Zf_all (maxiter, S', M+1), S' =
// S - n_el, and the lane floor (M+1):
//   iteration 0 runs all S rows, every later one the S' fresh rows; the
//   n_el elites carry their idx, beta and cost bit-unchanged;
//   a row's selection: the top k of |row[:M]| (K1's rules: NaN ranks last,
//   -0.0 equals +0.0, the lowest index wins a tie), K_mixed = kernel(D
//   rows, sigma = row[M]), K_red gathered from it, row sums, the weight QP
//   (rho K_red + reg I) b = r - mu 1 with r = rho / M row_sum, sum(b) = 1,
//   and its closed-form cost (-b.r - mu - reg |b|^2) / rho; a NaN cost
//   becomes +inf, a NaN beta 0;
//   the elites: the top n_el of -cost (lowest index first); res[c, t] the
//   least cost; the resample max(A_t @ elites + Zf_t, lane_floor);
//   the winner: the argmin of the last iteration's cost, its beta and idx,
//   and its sigma from the post-update batch (the reference's quirk).
//
// The arithmetic follows the plain chain on the card operation for
// operation, so that the kernel gives its bits where the order is free to
// choose: the IEEE quotient and expf of K3 (PyTorch's exp(-rows / sigma));
// the kernels' expressions of kernels.py with their roundings (x * x for
// sigma ** 2, a Python float times a tensor in float32); the row sums in
// the order of PyTorch's inner reduction on the card (torch_row_sum); the
// QP's matrix and right-hand side as the plain chain rounds them and K2's
// solve_system on them; its sums of n terms in PyTorch's order; the cost's
// division by rho as PyTorch divides by a Python float on the card (a
// product with the float32 reciprocal); the resample's dot products as a
// fused multiply-add chain over the elites, then the add of Zf_t.  The
// resample's product is cuBLAS's in the plain chain, whose order is not
// documented: where it differs, two costs within round-off may swap elites
// (the seed-1163 mechanism, ROADMAP Queue 3).
//
// What bounds it on the card: per launch it reads D (and D2), samples0,
// A_all and Zf_all once (1.2 MB at fastrt's 64 candidates) and does
// maxiter x C x S' x k x M exp/division pairs (7.0e6 at fastrt, 1.7e7 at
// the dynamic workload's shape): microseconds of either.  What it is
// instead is a chain: each candidate's iterations depend on each other,
// and within one a row's k top-k rounds, its k selected rows' sums and
// one thread's QP are dependent latency.  The design, right before fast:
// - one block of 8 warps per candidate (grid C): a block's bits do not
//   depend on the other candidates, so a chunk of scenarios equals each
//   scenario alone by construction; C <= 132 candidates run in one wave;
// - the state of a candidate lives in one block's shared memory where it
//   fits (Layout: the QP staging, costs, indices, weights, the elites, the
//   samples, D, D2, first fit in that order, each in shared memory if it
//   still fits in 227 KB, else in the candidate's slice of a device-memory
//   scratch the wrapper allocates); D and D2 are copied with cp.async at
//   block entry and waited for only after iteration 0's top-k rounds;
// - per iteration, phases between __syncthreads(): a warp per row does the
//   top-k rounds (indices to shared memory); a warp per row takes the k
//   selected rows of D, each lane its ceil(M/32) columns (a template on the
//   slots, 1, 2, 4 or 8), the row sums by warp shuffles and K_red's lower
//   triangle by shuffles from the lanes holding the selected columns; a
//   thread per row solves its QP (a template on k = 2 ... 16, the factor in
//   registers); warp 0 picks the elites; the block copies them and writes
//   the fresh rows.
// No fast-math (the build's flags): the quotients, expf and the sums must
// round as PyTorch's do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "ieee_div.cuh"
#include "qp_system.cuh"
#include "topk_rounds.cuh"

namespace {

using mmd_topk::kFull;
using mmd_topk::kPadKey;

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kMinK = 2, kMaxK = 16;
constexpr int kMaxM = 256;       // 8 columns a lane
constexpr int kMaxS = 256;       // the elite pick: 8 costs a lane
constexpr int kEliteSlots = kMaxS / kWarp;
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (227 KB)
// float(math.sqrt(5.0)): kernels.py's matern52 scalar, rounded as PyTorch
// rounds a Python float for a float32 tensor
constexpr float kSqrt5 = 2.2360679774997896964f;

enum Kind { kLaplace = 0, kGaussian = 1, kMatern52 = 2 };

// Where an array of a block's state lives: its offset in floats in shared
// memory or in the candidate's slice of the device-memory scratch.
struct Place {
  int off, shared;
};

// A block's state, placed first fit: each array in shared memory while it
// fits in kMaxSmem, else in device memory.  Every array starts 16 bytes
// aligned (D and D2 take 16-byte copies).
struct Layout {
  Place q, cost, idx, beta, el_sel, el_cost, el_idx, el_beta, ebuf, el_rows,
      samples, d, d2;
  int smem_floats, global_floats;
};

int round4(long long n) { return static_cast<int>((n + 3) / 4 * 4); }

Layout make_layout(int S, int M, int k, int n_el, int kind) {
  Layout L{};
  const int smem_cap = kMaxSmem / 4;
  auto put = [&](Place& p, long long n) {
    const int m = round4(n);
    if (L.smem_floats + m <= smem_cap) {
      p = {L.smem_floats, 1};
      L.smem_floats += m;
    } else {
      p = {L.global_floats, 0};
      L.global_floats += m;
    }
  };
  const int qs = k * (k + 1) / 2 + k;  // a row's QP: C's lower triangle, r
  put(L.q, static_cast<long long>(S) * qs);
  put(L.cost, S);
  put(L.idx, static_cast<long long>(S) * k);
  put(L.beta, static_cast<long long>(S) * k);
  put(L.el_sel, n_el);
  put(L.el_cost, n_el);
  put(L.el_idx, static_cast<long long>(n_el) * k);
  put(L.el_beta, static_cast<long long>(n_el) * k);
  put(L.ebuf, M >= 128 ? kWarps * M : 0);  // torch_row_sum's staged rows
  put(L.el_rows, static_cast<long long>(n_el) * (M + 1));
  put(L.samples, static_cast<long long>(S) * (M + 1));
  put(L.d, static_cast<long long>(M) * M);
  put(L.d2, kind == kLaplace ? 0 : static_cast<long long>(M) * M);
  return L;
}

constexpr int kVec = 4;  // PyTorch's vectorised loads of a float row

// 2^floor(log2 n), at most 32 (a warp)
__host__ __device__ constexpr int last_pow2(int n) {
  return n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

struct Args {
  const float *D, *D2, *samples0, *A_all, *Zf_all, *lane_floor;
  float *beta_w, *sigma_w, *res, *scratch;
  long long* idx_best;
  int S, M, n_el, maxiter, kind;
  float rho, reg, r_scale, inv_rho;
};

// The sum of n = N terms in the order of PyTorch's inner reduction on the
// card (ATen's Reduce.cuh) for n < 128, where a block row of W =
// min(2^floor(log2 n), 32) threads takes the terms x, x + W, ... in one
// accumulator each (added in that order) and the W partial sums meet by
// warp shuffles down at offsets W/2, W/4, ... 1: here in one thread, for
// the QP's sums of k products.
template <int N>
__device__ __forceinline__ float torch_sum(const float (&v)[N]) {
  constexpr int W = last_pow2(N);
  float p[W];
#pragma unroll
  for (int x = 0; x < W; ++x) {
    p[x] = v[x];
#pragma unroll
    for (int y = x + W; y < N; y += W) p[x] = __fadd_rn(p[x], v[y]);
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
    for (int x = 0; x < off; ++x) p[x] = __fadd_rn(p[x], p[x + off]);
  return p[0];
}

// The warp's row sum of one selected row's kernel values, every lane's
// e[t] holding column lane + 32 t (0 past M), in the order of PyTorch's
// inner reduction of that row on the card: for M < 128 a block row of W =
// min(2^floor(log2 M), 32) threads, thread x adding columns x, x + W, ...
// in order, then shuffles down at offsets W/2 ... 1; for M >= 128 the
// vectorised form, kVec-float loads from the first aligned column of the
// row (``shift`` floats past an aligned one in the plain chain's tensor),
// the head before it one column a thread, kVec accumulators a thread over
// the loads, the tail after the last whole load into the first, and a
// block row of min(2^floor(log2(M / kVec)), 32) threads.  Every lane
// returns the sum.  ebuf: the warp's M floats of shared memory, for M >=
// 128.
template <int kSlots>
__device__ __forceinline__ float torch_row_sum(const float (&e)[kSlots], int M, int lane,
                                               float* ebuf, int shift) {
  float p;
  int W = 32;
  if (M >= 128) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int col = lane + t * kWarp;
      if (col < M) ebuf[col] = e[t];
    }
    __syncwarp();
    W = last_pow2(M / kVec);
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    int h = 0;
    if (shift > 0) {
      h = kVec - shift;
      if (lane >= shift && lane < kVec) acc[0] = __fadd_rn(0.0f, ebuf[lane - shift]);
    }
    const int L = M - h, nvec = L / kVec;
    if (lane < W)
      for (int v = lane; v < nvec; v += W)
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = __fadd_rn(acc[i], ebuf[h + kVec * v + i]);
    if (lane < L % kVec) acc[0] = __fadd_rn(acc[0], ebuf[h + kVec * nvec + lane]);
    p = acc[0];
#pragma unroll
    for (int i = 1; i < kVec; ++i) p = __fadd_rn(p, acc[i]);
    __syncwarp();  // ebuf is rewritten by the next row
  } else if (M >= 32) {
    p = e[0];
#pragma unroll
    for (int t = 1; t < kSlots; ++t) p = __fadd_rn(p, e[t]);
  } else {
    W = last_pow2(M);
    // lane x < W: columns x and x + W (< 2W <= 32, one slot)
    p = __fadd_rn(e[0], __shfl_down_sync(kFull, e[0], W));
  }
  for (int off = W >> 1; off > 0; off >>= 1)
    p = __fadd_rn(p, __shfl_down_sync(kFull, p, off));
  return __shfl_sync(kFull, p, 0);
}

// One element of K_mixed from d = D[row, col] (and d2 = D2[row, col]) as
// kernels.py computes it on the card, each operation rounded as there:
// laplace exp(-d / sigma); gaussian exp(-d2 / (2 sigma^2)); matern52
// (1 + r1 + 5 d2 / (3 sigma^2)) exp(-r1), r1 = sqrt(5) d / sigma.  The
// quotients by the row's divisors (sig: sigma, den: 2 sigma^2 or 3
// sigma^2) take the fast path where ``fast`` says it is exact.
__device__ __forceinline__ float kernel_value(int kind, float d, float d2,
                                              mmd_div::Divisor sig, mmd_div::Divisor den,
                                              bool fast) {
  auto q = [fast](float a, mmd_div::Divisor dv) {
    return fast ? mmd_div::quotient(a, dv) : a / dv.b;
  };
  if (kind == kLaplace) return expf(q(-d, sig));
  if (kind == kGaussian) return expf(q(-d2, den));
  const float r1 = q(__fmul_rn(kSqrt5, d), sig);
  const float t2 = q(__fmul_rn(5.0f, d2), den);
  return __fmul_rn(__fadd_rn(__fadd_rn(1.0f, r1), t2), expf(-r1));
}

// The numerators of kernel_value, in the fast path's range
__device__ __forceinline__ bool numerators_in_range(int kind, float d, float d2) {
  if (kind == kLaplace) return mmd_div::in_range(d);
  if (kind == kGaussian) return mmd_div::in_range(d2);
  return mmd_div::in_range(__fmul_rn(kSqrt5, d)) && mmd_div::in_range(__fmul_rn(5.0f, d2));
}

__device__ __forceinline__ bool divisor_ok(float b) {
  return mmd_div::in_range(b) && b > 0.0f;
}

template <int K, int kSlots>
__global__ void __launch_bounds__(kThreads, 1)
inner_cem_kernel(const Args a, const Layout L) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int S = a.S, M = a.M, M1 = M + 1, n_el = a.n_el, Sf = S - n_el;
  constexpr int kTri = K * (K + 1) / 2;
  constexpr int kQ = kTri + K;  // a row's QP staging: C's lower triangle, r
  float* gs = a.scratch + static_cast<long long>(c) * L.global_floats;
  auto at = [&](Place p) { return (p.shared ? smem : gs) + p.off; };
  float* Q = at(L.q);
  float* cost = at(L.cost);
  int* idx = reinterpret_cast<int*>(at(L.idx));
  float* beta = at(L.beta);
  int* el_sel = reinterpret_cast<int*>(at(L.el_sel));
  float* el_cost = at(L.el_cost);
  int* el_idx = reinterpret_cast<int*>(at(L.el_idx));
  float* el_beta = at(L.el_beta);
  float* ebuf = at(L.ebuf) + warp * M;
  float* el_rows = at(L.el_rows);
  float* smp = at(L.samples);
  const long long MM = static_cast<long long>(M) * M;
  const float* Dg = a.D + c * MM;
  const float* D2g = a.kind == kLaplace ? nullptr : a.D2 + c * MM;
  const float* Dc = L.d.shared ? at(L.d) : Dg;
  const float* D2c = a.kind == kLaplace ? nullptr : (L.d2.shared ? at(L.d2) : D2g);

  // ---- the first batch, then D and D2 in flight under iteration 0's rounds
  if (L.samples.shared) {
    for (int i = threadIdx.x; i < S * M1; i += kThreads)
      mmd_async::copy4(smp + i, a.samples0 + i);
  } else {
    for (int i = threadIdx.x; i < S * M1; i += kThreads) smp[i] = a.samples0[i];
  }
  mmd_async::commit();
  auto stage = [&](float* dst, const float* src) {
    if (MM % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
      for (long long i = 4 * threadIdx.x; i < MM; i += 4 * kThreads)
        mmd_async::copy16(dst + i, src + i);
    } else {
      for (long long i = threadIdx.x; i < MM; i += kThreads) mmd_async::copy4(dst + i, src + i);
    }
  };
  if (L.d.shared) stage(at(L.d), Dg);
  if (D2g != nullptr && L.d2.shared) stage(at(L.d2), D2g);
  mmd_async::commit();
  mmd_async::wait<1>();
  __syncthreads();

  for (int t = 0; t < a.maxiter; ++t) {
    const int r0 = t == 0 ? 0 : n_el;
    const int rows = S - r0;  // rows of the plain chain's selection tensor

    // ---- A: the top k of |row[:M]|, a warp a row --------------------------
    for (int s = r0 + warp; s < S; s += kWarps) {
      const float* row = smp + static_cast<long long>(s) * M1;
      unsigned key[kSlots], col[kSlots];
#pragma unroll
      for (int u = 0; u < kSlots; ++u) {
        const int cc = lane + u * kWarp;
        key[u] = cc < M ? mmd_topk::rank_key(fabsf(row[cc])) : kPadKey;
        col[u] = cc;
      }
      mmd_topk::sort_slots<kSlots>(key, col);
      int sel = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int w = mmd_topk::round_winner<kSlots>(key, col);
        if (lane == i) sel = w;
      }
      if (lane < K) idx[s * K + lane] = sel;
    }
    if (t == 0) mmd_async::wait<0>();
    __syncthreads();

    // ---- B: K_mixed of the k selected rows, row sums, the QP's C and r ----
    for (int s = r0 + warp; s < S; s += kWarps) {
      const float sg = smp[static_cast<long long>(s) * M1 + M];
      const int my = lane < K ? idx[s * K + lane] : 0;
      const float s2 = __fmul_rn(sg, sg);
      const float dn = a.kind == kGaussian ? __fmul_rn(2.0f, s2) : __fmul_rn(3.0f, s2);
      const mmd_div::Divisor dsig = mmd_div::divisor(sg), dden = mmd_div::divisor(dn);
      const bool div_ok = divisor_ok(sg) && (a.kind == kLaplace || divisor_ok(dn));
      float* q = Q + s * kQ;
#pragma unroll 1
      for (int j = 0; j < K; ++j) {
        const int rj = __shfl_sync(kFull, my, j);
        float e[kSlots], e2[kSlots];
        bool ok = true;
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const int cc = min(lane + u * kWarp, M - 1);
          e[u] = Dc[rj * M + cc];
          e2[u] = D2c == nullptr ? 0.0f : D2c[rj * M + cc];
          ok = ok && numerators_in_range(a.kind, e[u], e2[u]);
        }
        const bool fast = div_ok && __all_sync(kFull, ok);
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const float v = kernel_value(a.kind, e[u], e2[u], dsig, dden, fast);
          e[u] = lane + u * kWarp < M ? v : 0.0f;
        }
        const long long flat = (static_cast<long long>(c) * rows + (s - r0)) * K + j;
        const float rs = torch_row_sum<kSlots>(e, M, lane, ebuf,
                                               static_cast<int>(flat * M % kVec));
        // K_red[j, l] = K_mixed[j, idx_l], from the lane holding column idx_l
        float g = 0.0f;
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
          const float gu = __shfl_sync(kFull, e[u], my % kWarp);
          if (my / kWarp == u) g = gu;
        }
        // rho K_red + reg I, rounded as the plain chain's two tensors add
        if (lane <= j)
          q[j * (j + 1) / 2 + lane] = __fadd_rn(__fmul_rn(a.rho, g), lane == j ? a.reg : 0.0f);
        if (lane == 0) q[kTri + j] = -__fmul_rn(a.r_scale, rs);
      }
    }
    __syncthreads();

    // ---- C: the weight QP and its cost, a thread a row --------------------
    for (int s = r0 + threadIdx.x; s < S; s += kThreads) {
      const float* q = Q + s * kQ;
      float A[K][K];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) A[i][j] = q[i * (i + 1) / 2 + j];
      float rv[K], bv[K], br[K], bb[K];
#pragma unroll
      for (int i = 0; i < K; ++i) rv[i] = q[kTri + i];
      const float mu = mmd_qp::solve_system<K>(A, rv, bv);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        br[i] = __fmul_rn(bv[i], rv[i]);
        bb[i] = __fmul_rn(bv[i], bv[i]);
      }
      const float num = __fsub_rn(__fsub_rn(-torch_sum<K>(br), mu),
                                  __fmul_rn(a.reg, torch_sum<K>(bb)));
      const float mmd = __fmul_rn(num, a.inv_rho);
      cost[s] = isnan(mmd) ? INFINITY : mmd;
#pragma unroll
      for (int i = 0; i < K; ++i) beta[s * K + i] = isnan(bv[i]) ? 0.0f : bv[i];
    }
    __syncthreads();

    // ---- D: the elites, the top n_el of -cost; the iteration's least cost -
    if (warp == 0) {
      unsigned key[kEliteSlots], col[kEliteSlots];
#pragma unroll
      for (int u = 0; u < kEliteSlots; ++u) {
        const int cc = lane + u * kWarp;
        key[u] = cc < S ? mmd_topk::rank_key(-cost[cc]) : kPadKey;
        col[u] = cc;
      }
      mmd_topk::sort_slots<kEliteSlots>(key, col);
      for (int i = 0; i < n_el; ++i) {
        const int w = mmd_topk::round_winner<kEliteSlots>(key, col);
        if (lane == 0) el_sel[i] = w;
      }
      __syncwarp();
      if (lane == 0) a.res[static_cast<long long>(c) * a.maxiter + t] = cost[el_sel[0]];
    }
    __syncthreads();

    // ---- E: the elites copied out, the winner, then the new batch ---------
    for (int i = threadIdx.x; i < n_el * M1; i += kThreads)
      el_rows[i] = smp[static_cast<long long>(el_sel[i / M1]) * M1 + i % M1];
    for (int i = threadIdx.x; i < n_el * K; i += kThreads) {
      el_idx[i] = idx[el_sel[i / K] * K + i % K];
      el_beta[i] = beta[el_sel[i / K] * K + i % K];
    }
    for (int i = threadIdx.x; i < n_el; i += kThreads) el_cost[i] = cost[el_sel[i]];
    if (t == a.maxiter - 1 && threadIdx.x < K) {
      // the argmin of cost is the first elite (the same rule picks both)
      a.beta_w[c * K + threadIdx.x] = beta[el_sel[0] * K + threadIdx.x];
      a.idx_best[c * K + threadIdx.x] = idx[el_sel[0] * K + threadIdx.x];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_el * M1; i += kThreads) smp[i] = el_rows[i];
    for (int i = threadIdx.x; i < n_el * K; i += kThreads) {
      idx[i] = el_idx[i];
      beta[i] = el_beta[i];
    }
    for (int i = threadIdx.x; i < n_el; i += kThreads) cost[i] = el_cost[i];
    const float* A_t = a.A_all + static_cast<long long>(t) * Sf * n_el;
    const float* Z_t = a.Zf_all + static_cast<long long>(t) * Sf * M1;
    for (int i = threadIdx.x; i < Sf * M1; i += kThreads) {
      const int f = i / M1, m = i % M1;
      const float* Af = A_t + f * n_el;
      float acc = 0.0f;
      for (int e = 0; e < n_el; ++e) acc = fmaf(Af[e], el_rows[e * M1 + m], acc);
      const float v = __fadd_rn(acc, Z_t[i]);
      // torch.maximum: NaN wins
      smp[static_cast<long long>(n_el) * M1 + i] = isnan(v) ? v : fmaxf(v, a.lane_floor[m]);
    }
    __syncthreads();
  }
  // the winner's sigma from the post-update batch
  if (threadIdx.x == 0) a.sigma_w[c] = smp[static_cast<long long>(el_sel[0]) * M1 + M];
}

template <int K, int kSlots>
int launch(const Args& a, const Layout& L, int C, cudaStream_t stream) {
  auto kernel = inner_cem_kernel<K, kSlots>;
  static const cudaError_t opted = cudaFuncSetAttribute(  // past 48 KB, once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  kernel<<<C, kThreads, static_cast<size_t>(L.smem_floats) * sizeof(float), stream>>>(a, L);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation with kSlots = slots (1, 2, 4 or 8)
template <int K>
int launch_slots(const Args& a, const Layout& L, int C, int slots, cudaStream_t stream) {
  switch (slots) {
    case 1: return launch<K, 1>(a, L, C, stream);
    case 2: return launch<K, 2>(a, L, C, stream);
    case 4: return launch<K, 4>(a, L, C, stream);
    case 8: return launch<K, 8>(a, L, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// k = K, K + 1, ... kMaxK: the instantiation whose k is k
template <int K = kMinK>
int launch_k(const Args& a, const Layout& L, int C, int k, int slots, cudaStream_t stream) {
  if (k == K) return launch_slots<K>(a, L, C, slots, stream);
  if constexpr (K < kMaxK) return launch_k<K + 1>(a, L, C, k, slots, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool takes(int S, int M, int k, int n_el, int maxiter, int kind) {
  return k >= kMinK && k <= kMaxK && k <= M && M <= kMaxM && S <= kMaxS &&
         n_el >= 1 && n_el < S && maxiter >= 1 && kind >= kLaplace && kind <= kMatern52;
}

}  // namespace

// Floats of device-memory scratch a candidate needs (its state that does
// not fit in shared memory); -1 outside the range the kernel takes.
extern "C" int mmd_inner_cem_scratch(int S, int M, int k, int n_el, int kind) {
  if (!takes(S, M, k, n_el, 1, kind)) return -1;
  return make_layout(S, M, k, n_el, kind).global_floats;
}

// D, D2 (C, M, M) (D2 null for laplace), samples0 (S, M+1), A_all
// (maxiter, S - n_el, n_el), Zf_all (maxiter, S - n_el, M+1), lane_floor
// (M+1); out beta_w (C, k), sigma_w (C,), idx_best (C, k) int64, res (C,
// maxiter); scratch (C, mmd_inner_cem_scratch(...)) floats.  r_scale:
// float32(-rho / M), inv_rho: float32(1) / float32(rho).  Returns
// cudaErrorInvalidValue outside the range the kernel takes (the wrapper
// checks first).
extern "C" int mmd_inner_cem(const float* D, const float* D2, const float* samples0,
                             const float* A_all, const float* Zf_all,
                             const float* lane_floor, float* beta_w, float* sigma_w,
                             long long* idx_best, float* res, float* scratch, int C,
                             int S, int M, int k, int n_el, int maxiter, int kind,
                             float rho, float reg, float r_scale, float inv_rho,
                             void* stream) {
  if (C <= 0) return 0;
  if (!takes(S, M, k, n_el, maxiter, kind) || (kind != kLaplace && D2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(S, M, k, n_el, kind);
  const int need = (M + kWarp - 1) / kWarp;
  const int slots = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  const Args a{D, D2, samples0, A_all, Zf_all, lane_floor, beta_w, sigma_w, res,
               scratch, idx_best, S, M, n_el, maxiter, kind, rho, reg, r_scale, inv_rho};
  return launch_k(a, L, C, k, slots, static_cast<cudaStream_t>(stream));
}
