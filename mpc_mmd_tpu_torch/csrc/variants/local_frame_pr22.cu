// Kernel (h) as first designed (a CTA's slab of K^-1 staged by one TMA
// bulk copy, the rounds' exchange by st.async a (row, CTA) pair, the path
// parameters in CTA 0 alone), kept as the yardstick that
// utils/kernel_ab.py --kernels kh times beside csrc/local_frame.cu
// (kh_pr22, kh_clock_pr22).  Not part of the package's build.
//
// Kernel (h): the closed loop's local path in one launch, the path
// smoother's `maxiter` alternating-minimisation rounds and the path
// parameters of the smoothed path (frenet.smooth_path followed by
// frenet.path_parameters), on one thread-block cluster.
//
// Replaces what XLA compiles from the JAX package's per-step path
// (mpc_mmd_tpu/frenet.py: smooth_path :111, its lax.scan :134, and
// path_parameters :148; called at closedloop.py:256-262), which the port
// ran as about 357 eager PyTorch launches a closed-loop step: 20
// matrix-vector products with the (n + 1)-square KKT inverse and some 314
// elementwise operations, then the path parameters' differences, squares,
// cumulative sum and curvature.  Like kernels (a) to (g) it replaces an
// XLA lowering, not a Pallas kernel.
//
// A round, per path point i < n (the waypoints wp, the carried alpha, d,
// lam):
//   b = wp + d cos(alpha) (x; sin for y), rhs = [lam + b, wp[0]] (n + 1);
//   x_s = (K^-1 rhs_x)[:n], y_s likewise, K^-1 = kkt_inv (n + 1, n + 1);
//   wc = x_s - x_wp, wsn = y_s - y_wp, alpha = atan2(wsn, wc),
//   d = min(wc cos(alpha) + wsn sin(alpha), threshold) (NaN kept);
//   lam -= wc - d cos(alpha) (x; y alike).
// The first round starts from alpha = 0, d = threshold, lam = 0.  After
// the last the path parameters of (x_s, y_s): the tangents Fx_dot, Fy_dot
// (a forward difference, the first repeated), their differences, the arc
// length's increments sqrt(Fx_dot^2 + Fy_dot^2), arc_vec = [0, their
// cumulative sum but the last], kappa = (Fy_ddot Fx_dot - Fx_ddot Fy_dot)
// / (Fx_dot^2 + Fy_dot^2)^1.5.
//
// The arithmetic is the chain's on the card, operation for operation, so
// that every output carries its bits:
//   - each product K^-1 rhs is ATen's mv, cuBLAS's gemv (the transposed
//     op on the row-major matrix; CUDA 12.8, PyTorch 2.11), whose order
//     the H100 gave up to probes (PERF.md): a row is one warp, lane l a
//     chain of fused multiply-adds from +0 over its terms in turn, then
//     the 32 partials added in a tree at offsets 16, 8, 4, 2, 1; from 516
//     columns on lane l's terms are l, l + 32, l + 64, ... (the gemvx
//     kernel), below it the block T l ... T l + T - 1, T = ceil((n + 1) /
//     32) (held from 65 columns; the kernel takes n >= 64).  The kernel
//     computes every row so;
//   - torch.cumsum of the 1-d increments is CUB's DeviceScan, not
//     ATen's row scan (torch_order.cuh cub_cumsum);
//   - every elementwise operation rounds on its own (__f*_rn: no
//     contraction), atan2f, cosf, sinf, sqrtf and powf as ATen's kernels
//     call them, ** 2 as x * x, the clamp's NaN kept, the quotient IEEE.
//
// What bounds it on the card: it reads K^-1's n rows once (1.44 MB at n =
// 600: 0.43 us at 3.35 TB/s) and does 2 maxiter n (n + 1) fused
// multiply-adds (7.2e6 at 10 rounds: 0.22 us at 67 TFLOP/s).  Neither
// binds: the rounds are a dependent chain, each a 601-term reduction, the
// elementwise update with three transcendental calls and an exchange of
// the new right-hand sides across the cluster.  The design:
//   - the n rows are split over a cluster of 16 CTAs (non-portable), in
//     units of 4 rows so that every CTA's slab of K^-1 starts on a 16-byte
//     boundary; thread 0 stages its slab once by a TMA bulk copy
//     (csrc/async_copy.cuh), 90 KB at num_path 600;
//   - a CTA is 8 warps and has at most 40 rows (64 to 639 path points): a
//     warp takes one group of at most 5 rows, whose terms of K^-1 it loads
//     once into its registers (95 floats a lane) and reads from there in
//     every round (a cluster of 8, 75 rows a CTA, read from the slab each
//     round, took twice as long: kernel_ab's kh_cluster8);
//   - every CTA holds both right-hand sides whole, as (x, y) pairs in two
//     buffers; at the start of a round each lane loads its 19 pairs into
//     registers, and a warp runs its group's 10 chains of fused
//     multiply-adds and butterflies side by side (the terms' loop unrolled
//     at num_path 600, the row's end a select); lane j then updates the
//     group's row j (atan2f, one sincosf), and the warp's lanes send the
//     rows' next pairs into the other buffer of every CTA by st.async,
//     each 8 bytes counted on that buffer's mbarrier there (a (row, CTA)
//     pair a lane).  A CTA starts a round when its buffer's mbarrier has
//     all n pairs: no cluster barrier runs in a round, and a buffer is
//     written again only after every CTA has sent the round that read it
//     (a warp a row, its update in all 32 lanes, spent the card's issue
//     slots on copies of the transcendental calls, and a cluster barrier
//     a round, with its fences, cost more than the round's products);
//   - after the last round every row's x_s, y_s go to CTA 0 the same way
//     (its own mbarrier), which computes the path parameters alone.
// The "// ---- kh:" marks delimit the phases kernel_ab's kh_clock times.
// ops/local_frame.py holds its twin (local_frame_twin), which sums in the
// same orders with tensors.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "torch_order.cuh"

namespace cg = cooperative_groups;

namespace {

using mmd_order::kFull;

constexpr int kWarp = 32;
constexpr int kWarps = 8;                      // warps a CTA
constexpr int kGroup = 5;                      // rows a warp takes at once (its group)
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxT = 20;                      // chunks of 32 of a row of K^-1
constexpr int kMaxN = kMaxT * kWarp - 1;       // path points: 639
constexpr int kMinN = 64;                      // path points: cuBLAS's blocked order from 65 columns
constexpr int kStridedFrom = 516;              // columns from which cuBLAS's lanes stride
constexpr int kUnit = 4;                       // rows a unit: whole 16-byte blocks
constexpr int kCluster = 16;                   // CTAs a launch (non-portable)
constexpr size_t kMaxSmem = 227 * 1024;
static_assert(kMinN / kUnit >= kCluster, "a CTA without rows");
static_assert(kUnit * (((kMaxN + kUnit - 1) / kUnit + kCluster - 1) / kCluster) <=
                  kWarps * kGroup,
              "a CTA with more groups than warps");
// the chunks of a row at the port's width (num_path 600: 601 columns, the
// strided order), unrolled at compile time
constexpr int kPathT = 19;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Shared memory, in floats: four mbarriers (the slab's copy, the two
// right-hand-side buffers, CTA 0's gather), the right-hand sides (2
// buffers of P (x, y) pairs, P = 32 T), the waypoints (x, y), the rows'
// multipliers (x, y), CTA 0's gathered path ((x, y) pairs), the
// increments, the scan's warp totals, then the slab of K^-1 (16-byte
// aligned)
struct Layout {
  int n, T, P, units, per, rhs, wp, lam, gather, inc, total, slab, floats;
};

__host__ __device__ inline Layout layout(int n) {
  Layout L;
  L.n = n;
  L.T = (n + 1 + kWarp - 1) / kWarp;
  L.P = L.T * kWarp;
  L.units = (n + kUnit - 1) / kUnit;
  L.per = kUnit * ((L.units + kCluster - 1) / kCluster);   // the most rows of a CTA
  L.rhs = 8;
  L.wp = L.rhs + 4 * L.P;
  L.lam = L.wp + 2 * round4(n);
  L.gather = L.lam + 2 * round4(L.per);
  L.inc = L.gather + 2 * round4(n);
  L.total = L.inc + round4(n);
  L.slab = L.total + 4;
  L.floats = L.slab + L.per * (n + 1);
  return L;
}

struct FrameArgs {
  const float* kinv;   // (n + 1, n + 1)
  const float* x_wp;   // (n,)
  const float* y_wp;
  float* out;          // (6, n): x_path, y_path, Fx_dot, Fy_dot, arc_vec, kappa
  int n, maxiter;
  float thr;
};

// the cluster's barrier: every CTA of it running, and its mbarriers'
// initialisation seen by all
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- distributed shared memory: a CTA's (x, y) pair into another CTA's
// shared memory, its 8 bytes counted on that CTA's mbarrier ----
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(mmd_async::smem_addr(p)), "r"(rank));
  return out;
}
__device__ __forceinline__ void send_pair(unsigned dst, float x, float y, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
      ::"r"(dst), "f"(x), "f"(y), "r"(bar) : "memory");
}
// wait for the phase of the given parity of a barrier that other CTAs
// complete (acquire at cluster scope)
__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT%=;\n"
      "}\n" ::"r"(mmd_async::smem_addr(bar)), "r"(parity)
      : "memory");
}

// A group's rows of K^-1 (``count`` rows from ``first`` of the slab),
// this lane's terms base + step t of each, into registers (0 past the
// row).  TT: the chunks T at compile time (the strided order at the
// port's width), or 0 (T at run time, either order)
template <int TT>
__device__ __forceinline__ void load_group(float (&a)[kGroup][kMaxT], const float* slab,
                                           int first, int count, int n, int T, int base,
                                           int step) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int k = TT > 0 ? base + kWarp * t : base + step * t;
      const bool live = j < count && (TT > 0 ? t < TT : t < T) && k <= n;
      a[j][t] = live ? slab[(first + j) * (n + 1) + k] : 0.0f;
    }
}

// The group's two products a row, in cuBLAS's gemv order: each lane a
// chain of fused multiply-adds from +0 over its terms in turn (none past
// the row's end: a select, not a branch), then the butterfly; the sums in
// every lane
template <int TT>
__device__ __forceinline__ void group_products(const float (&a)[kGroup][kMaxT],
                                               const float (&vx)[kMaxT],
                                               const float (&vy)[kMaxT], int n, int T,
                                               int base, int step, float (&sx)[kGroup],
                                               float (&sy)[kGroup]) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j) sx[j] = sy[j] = 0.0f;
#pragma unroll
  for (int t = 0; t < (TT > 0 ? TT : kMaxT); ++t) {
    const int k = TT > 0 ? base + kWarp * t : base + step * t;
    // at TT chunks every term but the last chunk's lies within the row
    const bool live = (TT > 0 && t < TT - 1) || ((TT > 0 || t < T) && k <= n);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float fx = fmaf(a[j][t], vx[t], sx[j]), fy = fmaf(a[j][t], vy[t], sy[j]);
      sx[j] = live ? fx : sx[j];
      sy[j] = live ? fy : sy[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      sx[j] = add(sx[j], __shfl_xor_sync(kFull, sx[j], off));
      sy[j] = add(sy[j], __shfl_xor_sync(kFull, sy[j], off));
    }
}

// v[j] of lane j's row (registers indexed at compile time)
__device__ __forceinline__ float pick(const float (&v)[kGroup], int j) {
  float out = v[0];
#pragma unroll
  for (int i = 1; i < kGroup; ++i)
    if (j == i) out = v[i];
  return out;
}

template <int TT>
__global__ void __launch_bounds__(kThreads, 1) local_frame_kernel(const FrameArgs a) {
  // ---- kh: begin
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n = a.n;
  const Layout L = layout(n);
  // mbarriers: the slab's copy, the two buffers, the gather
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm);
  uint64_t* copy_bar = bars;
  uint64_t* buf_bar = bars + 1;
  uint64_t* gather_bar = bars + 3;
  const int u0 = rank * L.units / kCluster, u1 = (rank + 1) * L.units / kCluster;
  const int r0 = kUnit * u0, rows = min(n, kUnit * u1) - r0;
  float* slab = sm + L.slab;

  // ---- staging: the slab by TMA (its whole 16-byte blocks; the rest, and
  // a matrix off a 16-byte boundary, by the threads)
  const float* src = a.kinv + static_cast<long long>(r0) * (n + 1);
  const int slab_count = rows * (n + 1);
  const int body = (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (slab_count & ~3) : 0;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mmd_async::mbar_init(bars + i);
    mmd_async::mbar_fence_init();
    mmd_async::mbar_expect(copy_bar, 4u * body);
    if (body > 0) mmd_async::bulk_copy(slab, src, 4u * body, copy_bar);
    // CTA 0 awaits every row's last x_s, y_s
    if (rank == 0) mmd_async::mbar_expect(gather_bar, 8u * n);
  }
  for (int e = body + tid; e < slab_count; e += kThreads) slab[e] = src[e];
  float* xw = sm + L.wp;
  float* yw = xw + round4(n);
  for (int i = tid; i < n; i += kThreads) {
    xw[i] = a.x_wp[i];
    yw[i] = a.y_wp[i];
  }
  float* lam_x = sm + L.lam;
  float* lam_y = lam_x + round4(L.per);
  __syncthreads();
  // the first round's right-hand sides, in every CTA: alpha 0, d the
  // threshold, lam 0; pair n the first waypoint in both buffers
  float2* rhs = reinterpret_cast<float2*>(sm + L.rhs);
  {
    const float c0 = cosf(0.0f), s0 = sinf(0.0f);
    const float dc = mul(a.thr, c0), ds = mul(a.thr, s0);
    for (int k = tid; k < L.P; k += kThreads) {
      float2 b = make_float2(0.0f, 0.0f);
      if (k < n) b = make_float2(add(0.0f, add(xw[k], dc)), add(0.0f, add(yw[k], ds)));
      else if (k == n) b = make_float2(xw[0], yw[0]);
      rhs[k] = b;
      rhs[L.P + k] = k == n ? b : make_float2(0.0f, 0.0f);
    }
    for (int r = tid; r < L.per; r += kThreads) {
      lam_x[r] = 0.0f;
      lam_y[r] = 0.0f;
    }
  }
  // every CTA running, and its mbarriers initialised, before any writes
  // into another's shared memory
  cluster_barrier();
  mmd_async::mbar_wait(copy_bar);

  // this lane's terms of a row: lane + 32 t (cuBLAS's kernel from
  // kStridedFrom columns on), or T lane + t, a block of T (below)
  const bool strided = TT > 0 || n + 1 >= kStridedFrom;
  const int base = strided ? lane : L.T * lane, step = strided ? kWarp : 1;
  // a warp's group of rows: their terms stay in its registers for every round
  const int first = kGroup * warp, count = min(kGroup, rows - first);
  float ak[kGroup][kMaxT];
  if (count > 0) load_group<TT>(ak, slab, first, count, n, L.T, base, step);
  for (int it = 0; it < a.maxiter; ++it) {
    // ---- kh: wait
    const bool last = it + 1 == a.maxiter;
    const float2* cur = rhs + (it & 1) * L.P;
    float2* next = rhs + ((it + 1) & 1) * L.P;
    uint64_t* next_bar = buf_bar + ((it + 1) & 1);
    // this round's right-hand sides: written by every CTA in the round
    // before (8 bytes a row), counted on their buffer's mbarrier
    if (it > 0) wait_parity(buf_bar + (it & 1), ((it - 1) >> 1) & 1);
    if (tid == 0 && !last) mmd_async::mbar_expect(next_bar, 8u * n);
    // ---- kh: products
    float vx[kMaxT], vy[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const float2 v = t < L.T ? cur[base + step * t] : make_float2(0.0f, 0.0f);
      vx[t] = v.x;
      vy[t] = v.y;
    }
    if (count > 0) {
      // the group's rows at once, a warp
      float sx[kGroup], sy[kGroup];
      group_products<TT>(ak, vx, vy, n, L.T, base, step, sx, sy);
      // ---- kh: update
      // lane j the group's row j
      const int r = first + lane, g = r0 + r;
      float ox = pick(sx, lane), oy = pick(sy, lane);
      if (!last && lane < count) {
        const float wc = sub(ox, xw[g]), wsn = sub(oy, yw[g]);
        const float al = atan2f(wsn, wc);
        float s, c;
        sincosf(al, &s, &c);
        const float d = mmd_order::clamp_max(add(mul(wc, c), mul(wsn, s)), a.thr);
        const float dc = mul(d, c), ds = mul(d, s);
        const float lx = sub(lam_x[r], sub(wc, dc)), ly = sub(lam_y[r], sub(wsn, ds));
        lam_x[r] = lx;
        lam_y[r] = ly;
        ox = add(lx, add(xw[g], dc));
        oy = add(ly, add(yw[g], ds));
      }
      // ---- kh: exchange
      if (last) {
        // the last round's x_s, y_s to CTA 0
        if (lane < count)
          send_pair(remote(sm + L.gather + 2 * g, 0), ox, oy, remote(gather_bar, 0));
      } else {
        // the exchange: the rows' next right-hand sides into every CTA's
        // other buffer, a (row, CTA) pair a lane
        for (int p0 = 0; p0 < count * kCluster; p0 += kWarp) {
          const int pr = p0 + lane, j = min(pr / kCluster, kGroup - 1);
          const float vxj = __shfl_sync(kFull, ox, j), vyj = __shfl_sync(kFull, oy, j);
          if (pr < count * kCluster)
            send_pair(remote(next + r0 + first + j, pr % kCluster), vxj, vyj,
                      remote(next_bar, pr % kCluster));
        }
      }
    }
  }

  // ---- the path parameters, in CTA 0, once every row's x_s, y_s is in
  if (rank == 0) {
    // ---- kh: gather
    wait_parity(gather_bar, 0);
    // ---- kh: path parameters
    const float2* gp = reinterpret_cast<const float2*>(sm + L.gather);
    float* out = a.out;
    float* inc = sm + L.inc;
    auto fx = [&](int j) { return j == 0 ? sub(gp[1].x, gp[0].x) : sub(gp[j].x, gp[j - 1].x); };
    auto fy = [&](int j) { return j == 0 ? sub(gp[1].y, gp[0].y) : sub(gp[j].y, gp[j - 1].y); };
    for (int i = tid; i < n; i += kThreads) {
      const float fxi = fx(i), fyi = fy(i);
      const float fxx = i == 0 ? sub(fx(1), fxi) : sub(fxi, fx(i - 1));
      const float fyy = i == 0 ? sub(fy(1), fyi) : sub(fyi, fy(i - 1));
      const float sq = add(mul(fxi, fxi), mul(fyi, fyi));
      inc[i] = __fsqrt_rn(sq);
      out[i] = gp[i].x;
      out[n + i] = gp[i].y;
      out[2 * n + i] = fxi;
      out[3 * n + i] = fyi;
      out[5 * n + i] = __fdiv_rn(sub(mul(fyy, fxi), mul(fxx, fyi)), powf(sq, 1.5f));
    }
    if (tid == 0) out[4 * n] = 0.0f;
    __syncthreads();
    // arc_vec[1 ..] the cumulative sum of the first n - 1 increments (a
    // scan's early outputs do not depend on its later items)
    mmd_order::cub_cumsum<2>(inc, out + 4 * n + 1, n - 1, sm + L.total);
  }
  // ---- kh: end
}

// once per instantiation: past the 48 KB default of dynamic shared memory,
// and a cluster of more than 8 CTAs
template <int TT>
cudaError_t opt_in() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(local_frame_kernel<TT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(local_frame_kernel<TT>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

template <int TT>
int launch(const FrameArgs& a, size_t smem, cudaStream_t stream) {
  const cudaError_t opted = opt_in<TT>();
  if (opted != cudaSuccess) return static_cast<int>(opted);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, local_frame_kernel<TT>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kinv (n + 1, n + 1), x_wp and y_wp (n,); out (6, n): x_path, y_path,
// Fx_dot, Fy_dot, arc_vec, kappa.  n is 64 ... 639, maxiter >= 1.
extern "C" int mmd_local_frame(const float* kinv, const float* x_wp, const float* y_wp,
                               float* out, int n, int maxiter, float threshold, void* stream) {
  if (n < kMinN || n > kMaxN || maxiter < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4 * static_cast<size_t>(layout(n).floats);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const FrameArgs a = {kinv, x_wp, y_wp, out, n, maxiter, threshold};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool path = (n + 1 + kWarp - 1) / kWarp == kPathT && n + 1 >= kStridedFrom;
  return path ? launch<kPathT>(a, smem, s) : launch<0>(a, smem, s);
}
