// Kernel (c)'s body: its layout, phases and launch, shared by the
// translation units that instantiate its forms (inner_cem.cu: "xla", "xt"
// and "g"; inner_cem_fused.cu: "fused").  inner_cem.cu's note has the
// design.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

#include "async_copy.cuh"
#include "ieee_div.cuh"
#include "qp_system.cuh"
#include "topk_kernel_rows.cuh"
#include "topk_rounds.cuh"
#include "torch_order.cuh"

namespace mmd_cem {

namespace cg = cooperative_groups;

using mmd_topk::kFull;
using mmd_topk::kPadKey;

constexpr int kWarp = 32;
constexpr int kMinK = 2, kMaxK = 16;
constexpr int kMaxM = 256;       // 8 columns a lane
constexpr int kMaxS = 256;       // the elite pick: 8 costs a lane; a warp's rows: one a lane
constexpr int kEliteSlots = kMaxS / kWarp;
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to (227 KB)
constexpr int kSizes[3] = {1, 2, 4};  // the cluster sizes a launch may take
// float(math.sqrt(5.0)): kernels.py's matern52 scalar, rounded as PyTorch
// rounds a Python float for a float32 tensor
constexpr float kSqrt5 = 2.2360679774997896964f;

enum Kind { kLaplace = 0, kGaussian = 1, kMatern52 = 2 };
// A launch's form: the selection whose chain it gives the bits of, its
// index in reduced_set.SELECTIONS
enum Form { kFormXla = 0, kFormXt = 1, kFormFused = 2, kFormG = 3 };

// Warps of a CTA at k = num_reduced: 16 where the QP's factor leaves room
// in 128 registers a thread (k <= 10), else 8 (up to 255 registers).
__host__ __device__ constexpr int warps_of(int k) { return k <= 10 ? 16 : 8; }

// CTAs an SM the launch bounds ask for: two where a CTA of 8 warps fits in
// 128 registers a thread
template <int K>
__host__ __device__ constexpr int min_blocks() {
  return K <= 10 && warps_of(K) == 8 ? 2 : 1;
}

// Selected rows of D a warp takes at once in phase B at k and a lane's
// column slots: all k (one group) at up to 2 slots, half of them at 4, two
// at 8 (the registers of J x slots values, and of D2's beside them)
__host__ __device__ constexpr int rows_at_once(int k, int slots) {
  return slots <= 2 ? k : slots <= 4 ? (k + 1) / 2 : 2;
}

// column slots a lane takes at M columns: 1, 2, 4 or 8
inline int slots_of(int M) {
  const int need = (M + 31) / 32;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
}

// Where an array of a CTA's state lives: its offset in floats in shared
// memory or in the CTA's slice of the device-memory scratch.
struct Place {
  int off, shared;
};

// A CTA's state at cluster size cs, placed first fit: each array in shared
// memory while it fits in kMaxSmem, else in device memory; the stage (the
// next iteration's A_t and Z_t rows) only where it fits.  Every array
// starts 16 bytes aligned.  A CTA holds the rows it owns: at most rows_cap
// of the S (iteration 0) and fresh_cap of the S' fresh ones, and with
// recompute also every elite's QP staging.  The "fused" form's row sums go
// through a warp buffer of kRedStride floats a selected row (K3's order),
// the others' through J x M floats a warp from M = 128 on (torch_row_sums).
struct Layout {
  Place q, cost, idx, beta, el_sel, el_cost, el_idx, el_beta, ebuf, floor, el_rows, samples,
      stage;
  int d_shared, d_off, d2_off;  // D and D2 whole in shared memory (else the inputs), offsets
  int cs, rows_cap, fresh_cap, smem_floats, global_floats;
};

inline int round4(long long n) { return static_cast<int>((n + 3) / 4 * 4); }

inline Layout make_layout(int S, int M, int k, int n_el, int kind, int cs, bool fused,
                          bool recompute) {
  Layout L{};
  const int smem_cap = kMaxSmem / 4;
  const int M1 = M + 1;
  L.cs = cs;
  L.rows_cap = (S + cs - 1) / cs;
  L.fresh_cap = (S - n_el + cs - 1) / cs;
  auto fits = [&](long long n) { return L.smem_floats + round4(n) <= smem_cap; };
  auto put = [&](Place& p, long long n) {
    const int m = round4(n);
    if (fits(n)) {
      p = {L.smem_floats, 1};
      L.smem_floats += m;
    } else {
      p = {L.global_floats, 0};
      L.global_floats += m;
    }
  };
  const int dm = kind == kLaplace ? 1 : 2;  // D, and D2 beside it
  const long long whole = static_cast<long long>(M) * M;
  auto put_d = [&]() {
    L.d_shared = fits(dm * round4(whole));
    if (L.d_shared) {
      const int n = round4(whole);
      L.d_off = L.smem_floats;
      L.d2_off = L.smem_floats + n;
      L.smem_floats += dm * n;
    }
  };
  // at up to 4 column slots a lane (M <= 128) D and D2 come first, so that
  // they always sit whole in shared memory (at most 128 KB), as the kernel
  // takes them there; wider, the rest of the state first
  const bool d_first = slots_of(M) <= 4;
  if (d_first) put_d();
  const int qs = k * (k + 1) / 2 + k;  // a row's QP: C's lower triangle, r
  const int q_rows = recompute ? std::max(L.rows_cap, L.fresh_cap + n_el) : L.rows_cap;
  put(L.q, static_cast<long long>(q_rows) * qs);
  put(L.cost, L.rows_cap);
  put(L.idx, static_cast<long long>(L.rows_cap) * k);
  put(L.beta, static_cast<long long>(L.rows_cap) * k);
  const int warps = warps_of(k);
  put(L.el_sel, static_cast<long long>(warps) * n_el);  // a warp's own copy
  put(L.el_cost, 2 * n_el);                             // two buffers: old, new
  put(L.el_idx, 2LL * n_el * k);
  put(L.el_beta, 2LL * n_el * k);
  const int J = rows_at_once(k, slots_of(M));
  put(L.ebuf, fused ? static_cast<long long>(J) * warps * mmd_k3::kRedStride
                   : M >= 128 ? static_cast<long long>(J) * warps * M : 0);
  put(L.floor, M1);
  put(L.el_rows, 2LL * n_el * M1);
  put(L.samples, static_cast<long long>(L.rows_cap) * M1);
  if (!d_first) put_d();
  const long long stage = static_cast<long long>(L.fresh_cap) * (n_el + M1);
  if (fits(stage)) {
    L.stage = {L.smem_floats, 1};
    L.smem_floats += round4(stage);
  }
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
  int C, S, M, n_el, maxiter, kind;
  float rho, reg, r_scale, inv_rho;
  int form, recompute;  // Form; the batch's elites run A-C again each iteration
  long long g_block;    // "g": floats of the chain's blocks of its exponential
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

// The warp's row sums of J selected rows' kernel values at once, every
// lane's e[i][t] holding row i's column lane + 32 t (0 past M), each in
// the order of PyTorch's inner reduction of that row on the card: for M <
// 128 a block row of W = min(2^floor(log2 M), 32) threads, thread x adding
// columns x, x + W, ... in order, then shuffles down at offsets W/2 ... 1;
// for M >= 128 the vectorised form, kVec-float loads from the first
// aligned column of the row (shift[i] floats past an aligned one in the
// plain chain's tensor), the head before it one column a thread, kVec
// accumulators a thread over the loads, the tail after the last whole load
// into the first, and a block row of min(2^floor(log2(M / kVec)), 32)
// threads.  The J rows' steps interleave; each row's order is its own.
// Every lane gets the sums.  ebuf: the warp's J x M floats of shared
// memory, for M >= 128.
template <int J, int kSlots>
__device__ __forceinline__ void torch_row_sums(const float (&e)[J][kSlots], int M, int lane,
                                               float* ebuf, const int (&shift)[J],
                                               float (&out)[J]) {
  float p[J];
  int W = 32;
  if (M >= 128) {
#pragma unroll
    for (int i = 0; i < J; ++i)
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int col = lane + t * kWarp;
        if (col < M) ebuf[i * M + col] = e[i][t];
      }
    __syncwarp();
    W = last_pow2(M / kVec);
#pragma unroll
    for (int i = 0; i < J; ++i) {
      const float* eb = ebuf + i * M;
      float acc[kVec];
#pragma unroll
      for (int x = 0; x < kVec; ++x) acc[x] = 0.0f;
      int h = 0;
      if (shift[i] > 0) {
        h = kVec - shift[i];
        if (lane >= shift[i] && lane < kVec) acc[0] = __fadd_rn(0.0f, eb[lane - shift[i]]);
      }
      const int L = M - h, nvec = L / kVec;
      if (lane < W)
        for (int v = lane; v < nvec; v += W)
#pragma unroll
          for (int x = 0; x < kVec; ++x) acc[x] = __fadd_rn(acc[x], eb[h + kVec * v + x]);
      if (lane < L % kVec) acc[0] = __fadd_rn(acc[0], eb[h + kVec * nvec + lane]);
      p[i] = acc[0];
#pragma unroll
      for (int x = 1; x < kVec; ++x) p[i] = __fadd_rn(p[i], acc[x]);
    }
    __syncwarp();  // ebuf is rewritten by the next rows
  } else if (M >= 32) {
#pragma unroll
    for (int i = 0; i < J; ++i) {
      p[i] = e[i][0];
#pragma unroll
      for (int t = 1; t < kSlots; ++t) p[i] = __fadd_rn(p[i], e[i][t]);
    }
  } else {
    W = last_pow2(M);
    // lane x < W: columns x and x + W (< 2W <= 32, one slot)
#pragma unroll
    for (int i = 0; i < J; ++i) p[i] = __fadd_rn(e[i][0], __shfl_down_sync(kFull, e[i][0], W));
  }
  for (int off = W >> 1; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < J; ++i) p[i] = __fadd_rn(p[i], __shfl_down_sync(kFull, p[i], off));
#pragma unroll
  for (int i = 0; i < J; ++i) out[i] = __shfl_sync(kFull, p[i], 0);
}

// The "fused" form's row sums of J selected rows at once, K3's order
// (topk_kernel_rows.cuh): each lane's partial over its kSlots columns into
// the warp's buffer (kRedStride floats a row), then lane i adds row i's 32
// partials 16 bytes at a time.  Every lane gets the sums.
template <int J, int kSlots>
__device__ __forceinline__ void k3_row_sums(const float (&e)[J][kSlots], int lane, float* buf,
                                            float (&out)[J]) {
#pragma unroll
  for (int i = 0; i < J; ++i)
    buf[i * mmd_k3::kRedStride + lane] = mmd_k3::lane_partial<kSlots>(e[i]);
  __syncwarp();
  const float mine = lane < J ? mmd_k3::partials_sum(buf + lane * mmd_k3::kRedStride) : 0.0f;
#pragma unroll
  for (int i = 0; i < J; ++i) out[i] = __shfl_sync(kFull, mine, i);
  __syncwarp();  // buf is rewritten by the next rows
}

// One element of K_mixed from d = D[row, col] (and d2 = D2[row, col]) as
// kernels.py computes it on the card, each operation rounded as there:
// laplace exp(-d / sigma); gaussian exp(-d2 / (2 sigma^2)); matern52
// (1 + r1 + 5 d2 / (3 sigma^2)) exp(-r1), r1 = sqrt(5) d / sigma.  The
// quotients by the row's divisors (sig: sigma, den: 2 sigma^2 or 3
// sigma^2) take the fast path with kFast, which callers take only where it
// is exact.
template <int kKind, bool kFast>
__device__ __forceinline__ float kernel_value(float d, float d2, mmd_div::Divisor sig,
                                              mmd_div::Divisor den) {
  auto q = [](float a, mmd_div::Divisor dv) {
    return kFast ? mmd_div::quotient(a, dv) : a / dv.b;
  };
  if (kKind == kLaplace) return expf(q(-d, sig));
  if (kKind == kGaussian) return expf(q(-d2, den));
  const float r1 = q(__fmul_rn(kSqrt5, d), sig);
  const float t2 = q(__fmul_rn(5.0f, d2), den);
  return __fmul_rn(__fadd_rn(__fadd_rn(1.0f, r1), t2), expf(-r1));
}

// The numerators of kernel_value, in the fast path's range
template <int kKind>
__device__ __forceinline__ bool numerators_in_range(float d, float d2) {
  if (kKind == kLaplace) return mmd_div::in_range(d);
  if (kKind == kGaussian) return mmd_div::in_range(d2);
  return mmd_div::in_range(__fmul_rn(kSqrt5, d)) & mmd_div::in_range(__fmul_rn(5.0f, d2));
}

// K_mixed of the selected rows I0 ... I0 + N - 1 of a group at the lane's
// columns (0 past M), from their D values ld(i, col) (and D2's, ld2(i,
// col)): every quotient takes the fast path when the divisors and all N
// rows' numerators allow it, else the division (the fast path is exact
// where it is taken, so the bits are the division's either way).  One
// branch for the N rows, and the kind a template argument, so that their
// N x kSlots elements are one block of independent work.
template <int kKind, int I0, int N, int J, int kSlots, class LoadD, class LoadD2>
__device__ __forceinline__ void kernel_rows(float (&e)[J][kSlots], LoadD ld, LoadD2 ld2, int M,
                                            int lane, mmd_div::Divisor sig,
                                            mmd_div::Divisor den, bool div_ok) {
  float e2[N][kSlots];
  bool ok = div_ok;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const int cc = min(lane + u * kWarp, M - 1);
      e[I0 + i][u] = ld(I0 + i, cc);
      e2[i][u] = kKind == kLaplace ? 0.0f : ld2(I0 + i, cc);
      ok = ok & numerators_in_range<kKind>(e[I0 + i][u], e2[i][u]);
    }
  if (__all_sync(kFull, ok)) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        e[I0 + i][u] = kernel_value<kKind, true>(e[I0 + i][u], e2[i][u], sig, den);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        e[I0 + i][u] = kernel_value<kKind, false>(e[I0 + i][u], e2[i][u], sig, den);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      if (lane + u * kWarp >= M) e[I0 + i][u] = 0.0f;
}

__device__ __forceinline__ bool divisor_ok(float b) {
  return mmd_div::in_range(b) && b > 0.0f;
}

// cp.async of n floats, 16 bytes a copy where both ends allow it, by the
// ``threads`` threads numbered ``tid``
__device__ __forceinline__ void copy_floats(float* dst, const float* src, long long n, int tid,
                                            int threads) {
  if (n % 4 == 0 && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
                     15u) == 0) {
    for (long long i = 4 * tid; i < n; i += 4 * threads) mmd_async::copy16(dst + i, src + i);
  } else {
    for (long long i = tid; i < n; i += threads) mmd_async::copy4(dst + i, src + i);
  }
}

// A candidate's rows split over its cluster: at iteration 0 all S rows,
// later the S' fresh ones (the elites stay in every CTA), per = ceil(rows
// / cs) to a CTA in order; a row's owner and its index there.
struct Split {
  int r0, per;
  __device__ int owner(int s) const { return (s - r0) / per; }
  __device__ int local(int s) const { return (s - r0) % per; }
};

// Phases, for every candidate (a cluster of cs CTAs, cs = 1, 2 or 4):
// each warp takes its CTA's rows w, w + 8, ..., two at a time through A
// (their top-k rounds interleaved) and each of them through B (J selected
// rows at once), then its lanes solve those rows' QPs (C), one a lane; a
// cluster barrier; every warp gathers the S costs from their owners and
// picks the elites (D); the CTA copies the elites from their owners, a
// cluster barrier, and each warp writes its own fresh rows of the next
// batch (E), their A_t and Z_t rows staged a whole iteration ahead.
// kFused: the "fused" form, phases A and B in K3's arithmetic; the other
// forms differ at run time (a.form) in the places of the row sums' rows and
// in the cost's sums.
template <int K, int kSlots, bool kFused>
__global__ void __launch_bounds__(warps_of(K) * kWarp, min_blocks<K>())
inner_cem_kernel(const Args a, const Layout L) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = warps_of(K), kThreads = kWarps * kWarp;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = L.cs;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / cs;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int S = a.S, M = a.M, M1 = M + 1, n_el = a.n_el, Sf = S - n_el;
  constexpr int kTri = K * (K + 1) / 2;
  constexpr int kQ = kTri + K;  // a row's QP staging: C's lower triangle, r
  constexpr int J = rows_at_once(K, kSlots);
  const int kStage = n_el + M1;  // floats of a stage row: A_t's, then Z_t's
  float* gs = a.scratch + static_cast<long long>(blockIdx.x) * L.global_floats;
  auto at = [&](Place p) { return (p.shared ? smem : gs) + p.off; };
  // the array at p of the cluster's CTA r
  auto at_rank = [&](Place p, int r) -> float* {
    if (r == rank) return at(p);
    if (p.shared) return cluster.map_shared_rank(smem + p.off, r);
    return a.scratch + static_cast<long long>(blockIdx.x - rank + r) * L.global_floats + p.off;
  };
  float* Q = at(L.q);
  float* cost = at(L.cost);
  int* idx = reinterpret_cast<int*>(at(L.idx));
  float* beta = at(L.beta);
  int* el_sel = reinterpret_cast<int*>(at(L.el_sel)) + warp * n_el;
  float* ebuf = at(L.ebuf) + warp * J * (kFused ? mmd_k3::kRedStride : M);
  float* lfloor = at(L.floor);
  float* smp = at(L.samples);
  float* stage = L.stage.shared ? smem + L.stage.off : nullptr;
  const long long MM = static_cast<long long>(M) * M;
  const float* Dg = a.D + c * MM;
  const float* D2g = a.kind == kLaplace ? nullptr : a.D2 + c * MM;
  // row rj of D (off = L.d_off) or D2 (L.d2_off), past 4 column slots a
  // lane (at up to 4, D is whole in shared memory: make_layout)
  auto d_row = [&](const float* g, int off, int rj) -> const float* {
    return L.d_shared ? smem + off + rj * M : g + static_cast<long long>(rj) * M;
  };
  const Split fresh{n_el, L.fresh_cap};
  const int fresh_lo = rank * L.fresh_cap;  // this CTA's first fresh row
  const int fresh_mine = max(0, min(L.fresh_cap, Sf - fresh_lo));
  // the rows of A_t and Z_t of the warp's fresh rows into the stage, in flight
  auto stage_rows = [&](const float* A_t, const float* Z_t) {
    for (int lr = warp; lr < fresh_mine; lr += kWarps) {
      const int f = fresh_lo + lr;
      const float* An = A_t + static_cast<long long>(f) * n_el;
      const float* Zn = Z_t + static_cast<long long>(f) * M1 - n_el;
      for (int x = lane; x < kStage; x += kWarp)
        mmd_async::copy4(stage + lr * kStage + x, x < n_el ? An + x : Zn + x);
    }
  };

  // ---- iteration 0's rows, D, the floor and A_0, Z_0 in flight
  {
    const int lo = rank * L.rows_cap, mine = max(0, min(L.rows_cap, S - lo));
    const float* src = a.samples0 + static_cast<long long>(lo) * M1;
    if (L.samples.shared) {
      copy_floats(smp, src, static_cast<long long>(mine) * M1, threadIdx.x, kThreads);
    } else {
      for (int i = threadIdx.x; i < mine * M1; i += kThreads) smp[i] = src[i];
    }
    if (L.floor.shared) {
      copy_floats(lfloor, a.lane_floor, M1, threadIdx.x, kThreads);
    } else {
      for (int i = threadIdx.x; i < M1; i += kThreads) lfloor[i] = a.lane_floor[i];
    }
    if (L.d_shared) {
      copy_floats(smem + L.d_off, Dg, MM, threadIdx.x, kThreads);
      if (D2g != nullptr) copy_floats(smem + L.d2_off, D2g, MM, threadIdx.x, kThreads);
    }
    if (stage != nullptr) stage_rows(a.A_all, a.Zf_all);
    mmd_async::commit();
    mmd_async::wait<0>();
  }
  cluster.sync();

  for (int t = 0; t < a.maxiter; ++t) {
    const int r0 = t == 0 ? 0 : n_el;
    const int nb = t & 1;  // the elites' buffer this iteration fills; 1 - nb holds the batch's
    // With recompute (the chain without elite-carry, where a row's sums
    // depend on its place), every CTA runs the batch's n_el elites through
    // A-C again before its own rows, their results over the carried ones,
    // and a row's place in the chain's tensor is its place in the batch.
    const int ne = a.recompute && t > 0 ? n_el : 0;
    const int pos0 = a.recompute ? 0 : r0;
    const int rows = S - pos0;  // rows of the plain chain's selection tensor
    const Split sp{r0, t == 0 ? L.rows_cap : L.fresh_cap};
    const int lo = r0 + rank * sp.per;  // this CTA's first row
    const int mine = max(0, min(sp.per, S - lo));
    const int nrows = ne + mine;  // the rows this CTA runs through A-C
    const int eo = (1 - nb) * n_el;  // the batch's elites in the el_ buffers
    auto row_of = [&](int lr) -> const float* {
      return lr < ne ? at(L.el_rows) + (eo + lr) * M1
                     : smp + static_cast<long long>(lr - ne) * M1;
    };
    __syncwarp();  // the warp's rows of the batch, written in E

#pragma unroll 1
    for (int p = warp; p < nrows; p += 2 * kWarps) {
      // ---- A: the top k of |row[:M]| of rows p and p + kWarps, rounds interleaved
      int sel[2];
      if constexpr (kFused) {
        // K3's rounds: a row with a NaN lane keeps the sentinel M
        unsigned key[2][kSlots];
        bool nan_row[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = p + r * kWarps;
          nan_row[r] = mmd_k3::row_keys<kSlots>(row_of(min(lr, nrows - 1)), M, lane,
                                                lr < nrows, key[r]);
          sel[r] = M;
        }
        // a NaN row's rounds run too, their winners dropped: no branch a
        // row, so that the two rows' reductions interleave
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const unsigned w = mmd_k3::round_winner<kSlots>(key[r], lane);
            if (lane == i && !nan_row[r]) sel[r] = static_cast<int>(w);
          }
      } else {
        unsigned key[2][kSlots], col[2][kSlots];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = p + r * kWarps;
          const float* row = row_of(lr);
#pragma unroll
          for (int u = 0; u < kSlots; ++u) {
            const int cc = lane + u * kWarp;
            key[r][u] = lr < nrows && cc < M ? mmd_topk::rank_key(fabsf(row[cc])) : kPadKey;
            col[r][u] = cc;
          }
          mmd_topk::sort_slots<kSlots>(key[r], col[r]);
        }
        sel[0] = sel[1] = 0;
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int w = mmd_topk::round_winner<kSlots>(key[r], col[r]);
            if (lane == i) sel[r] = w;
          }
      }

      // ---- B: K_mixed of each row's k selected rows, row sums, the QP's C and r
#pragma unroll 1
      for (int r = 0; r < 2; ++r) {
        const int lr = p + r * kWarps;
        if (lr >= nrows) break;
        const int my = r == 0 ? sel[0] : sel[1];
        if (lane < K)
          (lr < ne ? reinterpret_cast<int*>(at(L.el_idx)) + (eo + lr) * K
                   : idx + (lr - ne) * K)[lane] = my;
        const float sg = row_of(lr)[M];
        const float s2 = __fmul_rn(sg, sg);
        const float dn = a.kind == kGaussian ? __fmul_rn(2.0f, s2) : __fmul_rn(3.0f, s2);
        const mmd_div::Divisor dsig = mmd_div::divisor(sg), dden = mmd_div::divisor(dn);
        const bool div_ok = divisor_ok(sg) && (a.kind == kLaplace || divisor_ok(dn));
        float* q = Q + lr * kQ;
        // Where the plain chain's tensor holds the sums of the row's selected
        // row j (row rj of D), from M = 128 on (below, the sum's order does
        // not depend on it): its float offset, mod 4, is (s_base + j s_j + rj
        // s_r) mod 4.  "xla" sums a (C, rows, k, M) tensor, "xt" a (k, C,
        // rows, M) one (its index tensors strided apart, PyTorch gathers them
        // contiguous on the card), "g" the (per, rows, M, M) block of its
        // exponential, per = g_block / (rows M^2) candidates.
        int s_base = 0, s_j = 0, s_r = 0;
        if (!kFused && M >= 128) {
          const long long pos = lr < ne ? lr : lo + (lr - ne) - pos0;  // the row's place
          if (a.form == kFormG) {
            const long long per = max(1LL, a.g_block / (static_cast<long long>(rows) * M * M));
            s_base = static_cast<int>((c % per * rows + pos) * M % kVec * (M % kVec) % kVec);
            s_r = M % kVec;
          } else if (a.form == kFormXt) {
            s_base = static_cast<int>((c * static_cast<long long>(rows) + pos) * M % kVec);
            s_j = static_cast<int>(static_cast<long long>(a.C) * rows * M % kVec);
          } else {
            s_base = static_cast<int>((c * static_cast<long long>(rows) + pos) * K * M % kVec);
            s_j = M % kVec;
          }
        }
#pragma unroll 1
        for (int j0 = 0; j0 < K; j0 += J) {
          float e[J][kSlots];
          int shift[J], rj[J];
#pragma unroll
          for (int i = 0; i < J; ++i) {
            rj[i] = __shfl_sync(kFull, my, min(j0 + i, K - 1));
            shift[i] = (s_base + (j0 + i) * s_j + rj[i] * s_r) % kVec;
          }
          // the kernel values; with D2, half of the rows at a time (the
          // registers of both rows' values)
          constexpr int H = J > 2 ? (J + 1) / 2 : J;
          auto values = [&](auto ld, auto ld2) {
            if (a.kind == kLaplace) {
              kernel_rows<kLaplace, 0, J>(e, ld, ld2, M, lane, dsig, dden, div_ok);
            } else if (a.kind == kGaussian) {
              kernel_rows<kGaussian, 0, H>(e, ld, ld2, M, lane, dsig, dden, div_ok);
              if constexpr (H < J)
                kernel_rows<kGaussian, H, J - H>(e, ld, ld2, M, lane, dsig, dden, div_ok);
            } else {
              kernel_rows<kMatern52, 0, H>(e, ld, ld2, M, lane, dsig, dden, div_ok);
              if constexpr (H < J)
                kernel_rows<kMatern52, H, J - H>(e, ld, ld2, M, lane, dsig, dden, div_ok);
            }
          };
          float rs[J];
          if constexpr (kFused) {
            // laplace; the sentinel M reads a zero row, as K3's staged D
            auto none = [](int, int) { return 0.0f; };
            if constexpr (kSlots <= 4) {
              const float* d1 = smem + L.d_off;
              kernel_rows<kLaplace, 0, J>(
                  e, [&](int i, int cc) { return rj[i] < M ? d1[rj[i] * M + cc] : 0.0f; }, none,
                  M, lane, dsig, dden, div_ok);
            } else {
              const float* dr[J];
#pragma unroll
              for (int i = 0; i < J; ++i) dr[i] = d_row(Dg, L.d_off, min(rj[i], M - 1));
              kernel_rows<kLaplace, 0, J>(
                  e, [&](int i, int cc) { return rj[i] < M ? dr[i][cc] : 0.0f; }, none, M,
                  lane, dsig, dden, div_ok);
            }
            k3_row_sums<J, kSlots>(e, lane, ebuf, rs);
          } else {
            if constexpr (kSlots <= 4) {
              // D whole in shared memory: rows as offsets from its start
              const float* d1 = smem + L.d_off;
              const float* d2 = smem + L.d2_off;
              values([&](int i, int cc) { return d1[rj[i] * M + cc]; },
                     [&](int i, int cc) { return d2[rj[i] * M + cc]; });
            } else {
              const float* dr[J];
              const float* d2r[J];
#pragma unroll
              for (int i = 0; i < J; ++i) {
                dr[i] = d_row(Dg, L.d_off, rj[i]);
                d2r[i] = D2g == nullptr ? dr[i] : d_row(D2g, L.d2_off, rj[i]);
              }
              values([&](int i, int cc) { return dr[i][cc]; },
                     [&](int i, int cc) { return d2r[i][cc]; });
            }
            torch_row_sums<J, kSlots>(e, M, lane, ebuf, shift, rs);
          }
#pragma unroll
          for (int i = 0; i < J; ++i) {
            const int j = j0 + i;
            // K_red[j, l] = K_mixed[j, idx_l], from the lane holding column idx_l
            float g = 0.0f;
#pragma unroll
            for (int u = 0; u < kSlots; ++u) {
              const float gu = __shfl_sync(kFull, e[i][u], my % kWarp);
              if (my / kWarp == u) g = gu;
            }
            if (kFused && my >= M) g = 0.0f;  // K3's zero column of the sentinel
            if (j >= K) continue;
            // rho K_red + reg I, rounded as the plain chain's two tensors add
            if (lane <= j)
              q[j * (j + 1) / 2 + lane] =
                  __fadd_rn(__fmul_rn(a.rho, g), lane == j ? a.reg : 0.0f);
            if (lane == 0) q[kTri + j] = -__fmul_rn(a.r_scale, rs[i]);
          }
        }
      }
    }
    __syncwarp();

    // ---- C: the weight QP and its cost, a lane a row of the warp's
    {
      const int lr = warp + kWarps * lane;
      if (lr < nrows) {
        const float* q = Q + lr * kQ;
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
        // the k-term sums: "xt" reduces its (k, rows) tensors along the
        // strided axis, the others along the contiguous one
        float sbr, sbb;
        if (!kFused && a.form == kFormXt) {
          sbr = mmd_order::strided_sum<K>(br);
          sbb = mmd_order::strided_sum<K>(bb);
        } else {
          sbr = torch_sum<K>(br);
          sbb = torch_sum<K>(bb);
        }
        const float num = __fsub_rn(__fsub_rn(-sbr, mu), __fmul_rn(a.reg, sbb));
        const float mmd = __fmul_rn(num, a.inv_rho);
        (lr < ne ? at(L.el_cost) + eo + lr : cost + (lr - ne))[0] = isnan(mmd) ? INFINITY : mmd;
        float* bdst = lr < ne ? at(L.el_beta) + (eo + lr) * K : beta + (lr - ne) * K;
#pragma unroll
        for (int i = 0; i < K; ++i) bdst[i] = isnan(bv[i]) ? 0.0f : bv[i];
      }
    }
    cluster.sync();

    // ---- D: every warp: the S costs from their owners, the elites (top n_el of -cost)
    float* el_cost = at(L.el_cost);
    int* el_idx = reinterpret_cast<int*>(at(L.el_idx));
    float* el_beta = at(L.el_beta);
    float* el_rows = at(L.el_rows);
    auto pick = [&](auto slots) {
      constexpr int kE = decltype(slots)::value;
      unsigned key[kE], col[kE];
#pragma unroll
      for (int u = 0; u < kE; ++u) {
        const int s = lane + u * kWarp;
        float v = 0.0f;
        if (s < r0) {
          v = el_cost[(1 - nb) * n_el + s];
        } else if (s < S) {
          v = at_rank(L.cost, sp.owner(s))[sp.local(s)];
        }
        key[u] = s < S ? mmd_topk::rank_key(-v) : kPadKey;
        col[u] = s;
      }
      mmd_topk::sort_slots<kE>(key, col);
      for (int i = 0; i < n_el; ++i) {
        const int w = mmd_topk::round_winner<kE>(key, col);
        if (lane == 0) el_sel[i] = w;
      }
    };
    if (S <= 64) {
      pick(std::integral_constant<int, 2>());
    } else if (S <= 128) {
      pick(std::integral_constant<int, 4>());
    } else {
      pick(std::integral_constant<int, kEliteSlots>());
    }
    __syncwarp();

    // ---- E: the elites copied from their owners, then the new batch
    {
      float* rows_n = el_rows + nb * n_el * M1;
      const float* rows_o = el_rows + (1 - nb) * n_el * M1;
      // a warp an elite: its row, idx, beta and cost from its owner (or
      // from the last elites)
      for (int e = warp; e < n_el; e += kWarps) {
        const int s = el_sel[e];
        const bool kept = s < r0;
        const int o = kept ? rank : sp.owner(s), l = kept ? s : sp.local(s);
        const float* src = kept ? rows_o + s * M1 : at_rank(L.samples, o) + l * M1;
        float v[kSlots + 1];
#pragma unroll
        for (int u = 0; u <= kSlots; ++u) v[u] = src[min(lane + u * kWarp, M1 - 1)];
#pragma unroll
        for (int u = 0; u <= kSlots; ++u)
          if (lane + u * kWarp < M1) rows_n[e * M1 + lane + u * kWarp] = v[u];
        const int* idx_src = kept ? el_idx + (1 - nb) * n_el * K + s * K
                                  : reinterpret_cast<int*>(at_rank(L.idx, o)) + l * K;
        const float* beta_src = kept ? el_beta + (1 - nb) * n_el * K + s * K
                                     : at_rank(L.beta, o) + l * K;
        if (lane < K) {
          el_idx[nb * n_el * K + e * K + lane] = idx_src[lane];
          el_beta[nb * n_el * K + e * K + lane] = beta_src[lane];
        }
        if (lane == 0)
          el_cost[nb * n_el + e] = kept ? el_cost[(1 - nb) * n_el + s] : at_rank(L.cost, o)[l];
      }
      // ---- E1: the barrier's arrival, the CTA's barrier, the least cost
      // the cluster barrier that lets the owners overwrite their rows: its
      // arrival here, its wait only before the first store of a fresh row,
      // so that the first row's products run while the other CTAs finish
      // their copies
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      __syncthreads();  // the elites, copied by every warp
      // the iteration's least cost: the first elite's (the same rule picks both)
      if (rank == 0 && threadIdx.x == 0)
        a.res[static_cast<long long>(c) * a.maxiter + t] = el_cost[nb * n_el];
      // the warp's fresh rows: max(A_t @ elites + Z_t, floor)
      if (stage != nullptr) {
        mmd_async::wait<0>();
        __syncwarp();
      }
      const float* A_t = a.A_all + static_cast<long long>(t) * Sf * n_el;
      const float* Z_t = a.Zf_all + static_cast<long long>(t) * Sf * M1;
      bool waited = false;
      // ---- E2: the resample of the warp's fresh rows, two at a time
      for (int lr0 = warp; lr0 < fresh_mine; lr0 += 2 * kWarps) {
        const float* Af[2];
        const float* Zf[2];
        bool live[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = lr0 + r * kWarps;
          live[r] = lr < fresh_mine;
          const int l = live[r] ? lr : lr0;
          const int f = fresh_lo + l;
          Af[r] = stage != nullptr ? stage + l * kStage : A_t + f * n_el;
          Zf[r] = stage != nullptr ? stage + l * kStage + n_el : Z_t + f * M1;
        }
        // the lane's columns lane + 32 u at once, each an FMA chain over the elites
        float acc[2][kSlots + 1];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u <= kSlots; ++u) acc[r][u] = 0.0f;
#pragma unroll 4
        for (int e = 0; e < n_el; ++e) {
          const float* er = rows_n + e * M1;
          const float a0 = Af[0][e], a1 = Af[1][e];
#pragma unroll
          for (int u = 0; u <= kSlots; ++u) {
            const float x = er[min(lane + u * kWarp, M1 - 1)];
            acc[0][u] = fmaf(a0, x, acc[0][u]);
            acc[1][u] = fmaf(a1, x, acc[1][u]);
          }
        }
        if (!waited) {
          asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
          waited = true;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!live[r]) continue;
          float* row = smp + static_cast<long long>(lr0 + r * kWarps) * M1;
#pragma unroll
          for (int u = 0; u <= kSlots; ++u) {
            const int m = lane + u * kWarp;
            if (m < M1) {
              const float v = __fadd_rn(acc[r][u], Zf[r][m]);
              // torch.maximum: NaN wins
              row[m] = isnan(v) ? v : fmaxf(v, lfloor[m]);
            }
          }
        }
      }
      if (!waited) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      // ---- E3: the next iteration's A_t and Z_t rows, in flight under it
      if (stage != nullptr && t + 1 < a.maxiter) {
        __syncwarp();
        stage_rows(A_t + static_cast<long long>(Sf) * n_el,
                   Z_t + static_cast<long long>(Sf) * M1);
        mmd_async::commit();
      }
    }
  }
  cluster.sync();
  // the winner's sigma from the post-update batch
  const int nb = (a.maxiter - 1) & 1;  // the last iteration's elites
  if (rank == 0 && threadIdx.x == 0) {
    const int s = el_sel[0];
    const float* rows_n = at(L.el_rows) + nb * n_el * M1;
    a.sigma_w[c] = s < n_el ? rows_n[s * M1 + M]
                            : at_rank(L.samples, fresh.owner(s))[fresh.local(s) * M1 + M];
  }
  // the winner: the argmin of the last iteration's cost is its first elite
  if (rank == 0 && threadIdx.x < K) {
    a.beta_w[c * K + threadIdx.x] = at(L.el_beta)[nb * n_el * K + threadIdx.x];
    a.idx_best[c * K + threadIdx.x] =
        reinterpret_cast<int*>(at(L.el_idx))[nb * n_el * K + threadIdx.x];
  }
  cluster.sync();  // no CTA leaves while rank 0 may read its shared memory
}

// Clusters of cs CTAs that the card holds at once for an instantiation at
// smem_bytes of shared memory a CTA (cudaOccupancyMaxActiveClusters),
// asked once per (cs, bytes); 0 if none fits.  Returns a CUDA error, or 0.
template <int K, int kSlots, bool kFused>
int active_clusters(int cs, int smem_bytes, int* n) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(cs, smem_bytes);
  const auto hit = seen.find(key);
  if (hit != seen.end()) {
    *n = hit->second;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(warps_of(K) * kWarp);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(n, inner_cem_kernel<K, kSlots, kFused>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  seen[key] = *n;
  return 0;
}

// The cluster size of a launch of C candidates, from the clusters of each
// size the card holds at once (active): the size whose grid takes the
// fewest waves per CTA of a candidate (waves / size, a wave = active
// clusters), so that a grid runs in one wave where it can and a candidate
// spreads over as many SMs as fill the card; a tie goes to the smaller
// size (fewer cluster barriers and remote reads).  0 if no size fits.
inline int cluster_size(int C, const int (&active)[3]) {
  int best = -1;
  long long best_cost = 0;
  for (int i = 0; i < 3; ++i) {
    if (active[i] <= 0) continue;
    const long long cost = (C + active[i] - 1) / active[i] * (4 / kSizes[i]);
    if (best < 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best < 0 ? 0 : kSizes[best];
}

inline int last_cluster = 0;  // the cluster size of the last launch

template <int K, int kSlots, bool kFused>
int launch(const Args& a, const Layout (&L)[3], int C, cudaStream_t stream) {
  auto kernel = inner_cem_kernel<K, kSlots, kFused>;
  static const cudaError_t opted = cudaFuncSetAttribute(  // past 48 KB, once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  int active[3];
  for (int i = 0; i < 3; ++i) {
    const int err =
        active_clusters<K, kSlots, kFused>(kSizes[i], L[i].smem_floats * 4, &active[i]);
    if (err != 0) return err;
  }
  const int cs = cluster_size(C, active);
  const int i = cs == 1 ? 0 : cs == 2 ? 1 : cs == 4 ? 2 : -1;
  if (i < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  last_cluster = cs;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * cs);
  cfg.blockDim = dim3(warps_of(K) * kWarp);
  cfg.dynamicSmemBytes = static_cast<size_t>(L[i].smem_floats) * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, L[i]);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation with kSlots = slots (1, 2, 4 or 8)
template <int K, bool kFused>
int launch_slots(const Args& a, const Layout (&L)[3], int C, int slots,
                 cudaStream_t stream) {
  switch (slots) {
    case 1: return launch<K, 1, kFused>(a, L, C, stream);
    case 2: return launch<K, 2, kFused>(a, L, C, stream);
    case 4: return launch<K, 4, kFused>(a, L, C, stream);
    case 8: return launch<K, 8, kFused>(a, L, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// k = K, K + 1, ... kMaxK: the instantiation whose k is k
template <bool kFused, int K = kMinK>
int launch_k(const Args& a, const Layout (&L)[3], int C, int k, int slots,
             cudaStream_t stream) {
  if (k == K) return launch_slots<K, kFused>(a, L, C, slots, stream);
  if constexpr (K < kMaxK) return launch_k<kFused, K + 1>(a, L, C, k, slots, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The "fused" form's launch, instantiated in inner_cem_fused.cu (a
// translation unit of its own, so that the per-source nvcc runs it beside
// the other forms' instantiations)
int launch_fused(const Args& a, const Layout (&L)[3], int C, int k, int slots,
                 cudaStream_t stream);

inline bool takes(int S, int M, int k, int n_el, int maxiter, int kind, int form) {
  return k >= kMinK && k <= kMaxK && k <= M && M <= kMaxM && S <= kMaxS &&
         n_el >= 1 && n_el < S && maxiter >= 1 && kind >= kLaplace && kind <= kMatern52 &&
         form >= kFormXla && form <= kFormG &&
         (kind == kLaplace || (form != kFormFused && form != kFormG));
}

}  // namespace mmd_cem
