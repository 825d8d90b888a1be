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
//     units of 4 rows so that every CTA's rows of a right-hand side start
//     on a 32-byte boundary; a CTA is 8 warps and has at most 40 rows (64
//     to 639 path points): a warp takes one group of at most 5 rows;
//   - staging: each warp stages its own group's terms of K^-1 (its rows
//     are contiguous in device memory) by one TMA bulk copy of its own on
//     its own mbarrier into its slab of shared memory, and reads them from
//     there into its registers (95 floats a lane) just before round 0,
//     keeping them for every round; the copies are in flight while the CTA
//     loads the waypoints and builds round 0's right-hand sides, which need
//     no K^-1.  (The warp's loads from device memory straight into its
//     registers, lanes on neighbouring floats of a row, held a warp ~6,500
//     cycles to issue and were 0.2 us a launch slower in turns; the first
//     design's one 90 KB bulk copy a CTA, behind one mbarrier, took 17% of
//     the launch.)
//   - every CTA holds both right-hand sides whole, as (x, y) pairs in two
//     buffers; at the start of a round each lane loads its 19 pairs into
//     registers, and a warp runs its group's 10 chains of fused
//     multiply-adds and butterflies side by side (the terms' loop unrolled
//     at num_path 600, the row's end a select); lane j then updates the
//     group's row j (atan2f, one sincosf) and writes the row's next pair
//     into the CTA's own other buffer;
//   - exchange: after one CTA barrier (and a proxy fence, so that the
//     copies see the threads' writes) lanes 0 and 1 of warp w copy the
//     CTA's rows of that buffer into peers w and w + 8 by cp.async.bulk
//     (shared::cta to shared::cluster, at most 320 bytes; one instruction
//     a warp), counted on the peer's mbarrier for that buffer: 15 arrivals
//     a buffer a round instead of one a (row, CTA) pair.  A CTA starts a
//     round when its buffer's mbarrier has every peer's rows: no cluster
//     barrier runs in a round, and a buffer is written again only after
//     every CTA has sent the round that read it.  (Issuing the copies
//     costs about 400 cycles a round this way; 15 lanes of one warp took
//     ~960, lane 0 of each warp two in turn ~660; 16-byte stores with a
//     release arrival a peer ~2,300; 16-byte st.async stores a (peer,
//     block) pair a thread, were 0.5 us a launch slower in turns);
//   - the last round is exchanged like the others, and each CTA computes
//     its own rows' path parameters from its buffer (a row's neighbours are
//     in it); CTA 0 takes every row's arc length increment from its own
//     buffer too, and scans them (no gather) before its own rows, which
//     the warps past the scan's take.  A cluster barrier at the end keeps
//     every CTA's shared memory until the copies out of it have landed,
//     and the one at the start is split: a CTA arrives once its mbarriers
//     and buffers are ready and waits only before its first copy, so that
//     the CTAs' start and the waypoints overlap round 0.
// A wait on an mbarrier that has not completed within about a second
// traps (a launch error, not a hang).
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
__host__ __device__ inline int round2(int n) { return (n + 1) & ~1; }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Shared memory, in floats: the mbarriers (the two right-hand-side
// buffers', then a warp's staging copy's), the right-hand sides (2
// buffers of P (x, y) pairs, P = 32 T), the waypoints (x, y), the rows'
// multipliers (x, y), CTA 0's increments, the scan's warp totals, and a
// slab a warp for its rows of K^-1 (4 floats ahead,
// so that a row starting anywhere in a 16-byte block lands its first whole
// block aligned); every offset a multiple of 4 floats
struct Layout {
  int n, T, P, units, per, rhs, wp, lam, inc, total, slab, per_warp, floats;
};

__host__ __device__ inline Layout layout(int n) {
  Layout L;
  L.n = n;
  L.T = (n + 1 + kWarp - 1) / kWarp;
  L.P = L.T * kWarp;
  L.units = (n + kUnit - 1) / kUnit;
  L.per = kUnit * ((L.units + kCluster - 1) / kCluster);   // the most rows of a CTA
  L.rhs = round4(2 * (2 + kWarps));
  L.wp = L.rhs + 4 * L.P;
  L.lam = L.wp + 2 * round4(n);
  L.inc = L.lam + 2 * round4(L.per);
  L.total = L.inc + round4(n);
  L.slab = L.total + 4;
  L.per_warp = round4(kGroup * (n + 1) + 4);
  L.floats = L.slab + kWarps * L.per_warp;
  return L;
}

// the first row of CTA q and its rows
__device__ __forceinline__ int first_row(const Layout& L, int q) {
  return kUnit * (q * L.units / kCluster);
}
__device__ __forceinline__ int rows_of(const Layout& L, int q) {
  return min(L.n, kUnit * ((q + 1) * L.units / kCluster)) - first_row(L, q);
}

struct FrameArgs {
  const float* kinv;   // (n + 1, n + 1)
  const float* x_wp;   // (n,)
  const float* y_wp;
  float* out;          // (6, n): x_path, y_path, Fx_dot, Fy_dot, arc_vec, kappa
  int n, maxiter;
  float thr;
};

// the cluster's barrier, in two halves: a CTA arrives once its mbarriers
// and buffers are ready, and waits before its first copy into another
// CTA, so that the barrier's latency overlaps round 0's products.  The
// arrival orders no memory (relaxed): the mbarriers' initialisation is
// published by fence.mbarrier_init, no copy writes what a CTA's threads
// write, and at the end only the copies' completion matters, which each
// CTA has seen on its mbarriers before it arrives (a release there waited
// for the outputs' stores, about 2,500 cycles)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- distributed shared memory ----
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(mmd_async::smem_addr(p)), "r"(rank));
  return out;
}
// bytes (a multiple of 16) of this CTA's shared memory at src into the
// cluster address dst, counted on the cluster address bar
__device__ __forceinline__ void copy_to_peer(unsigned dst, const void* src, unsigned bytes,
                                             unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(mmd_async::smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// the threads' writes to shared memory seen by the copies (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ bool try_wait_parity(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(mmd_async::smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}
// wait for the phase of the given parity of a barrier that other CTAs
// complete (acquire at cluster scope); trap past about a second
constexpr long long kHangCycles = 2000000000LL;
__device__ __forceinline__ void wait_parity(uint64_t* bar, unsigned parity) {
  if (try_wait_parity(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_wait_parity(bar, parity)) {
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

// A group's rows of K^-1 (``count`` rows from ``src``, rows n + 1 floats
// apart in the warp's slab), this lane's terms base + step t of each, into
// registers (0 past the row).  TT: the chunks T at compile time (the
// strided order at the port's width), or 0 (T at run time, either order)
template <int TT>
__device__ __forceinline__ void load_group(float (&a)[kGroup][kMaxT],
                                           const float* __restrict__ src, int count, int n,
                                           int T, int base, int step) {
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int k = TT > 0 ? base + kWarp * t : base + step * t;
      const bool live = j < count && (TT > 0 ? t < TT : t < T) && k <= n;
      a[j][t] = live ? src[j * (n + 1) + k] : 0.0f;
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
  // mbarriers: the two buffers, then a warp's staging copy's
  uint64_t* buf_bar = reinterpret_cast<uint64_t*>(sm);
  const int r0 = first_row(L, rank), rows = rows_of(L, rank);
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) mmd_async::mbar_init(buf_bar + i);
    mmd_async::mbar_fence_init();
  }
  // the waypoints' loads first, all at once, so that they do not queue
  // behind K^-1's; stored once K^-1's are issued
  constexpr int kPoints = (kMaxN + kThreads - 1) / kThreads;
  float wx[kPoints], wy[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = tid + j * kThreads;
    wx[j] = i < n ? __ldg(a.x_wp + i) : 0.0f;
    wy[j] = i < n ? __ldg(a.y_wp + i) : 0.0f;
  }

  // ---- staging: a warp's group of rows by one bulk copy of its own into
  // its slab (its whole 16-byte blocks; the at most 6 floats around them
  // by its lanes), in flight while the CTA builds round 0's right-hand
  // sides, and into its registers for every round before round 0; this
  // lane's terms of a row: lane + 32 t (cuBLAS's kernel from kStridedFrom
  // columns on), or T lane + t, a block of T (below)
  const bool strided = TT > 0 || n + 1 >= kStridedFrom;
  const int base = strided ? lane : L.T * lane, step = strided ? kWarp : 1;
  const int first = kGroup * warp, count = min(kGroup, rows - first);
  const float* src = a.kinv + static_cast<long long>(r0 + first) * (n + 1);
  float ak[kGroup][kMaxT];
  uint64_t* copy_bar = buf_bar + 2 + warp;
  const int elems = count > 0 ? count * (n + 1) : 0;
  const int head =
      min(elems, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
  const int body = (elems - head) & ~3;
  float* slab = sm + L.slab + warp * L.per_warp + 4 - head;   // element e at slab[e]
  if (count > 0) {
    if (lane == 0) {
      mmd_async::mbar_init(copy_bar);
      mmd_async::mbar_fence_init();
      mmd_async::mbar_expect(copy_bar, 4u * body);
      if (body > 0) mmd_async::bulk_copy(slab + head, src + head, 4u * body, copy_bar);
    }
    const int e = lane < head ? lane : head + body + lane - head;
    if (lane < head || (lane >= head && e < elems)) slab[e] = src[e];
  }
  // what a buffer receives a round: every peer's rows, each copy a whole
  // number of 16-byte blocks (the last CTA's odd number of rows, at an odd
  // n, rounded up to take pair n, which is the same in every CTA)
  unsigned rhs_bytes = 0;
  for (int q = 0; q < kCluster; ++q)
    if (q != rank) rhs_bytes += 8u * round2(rows_of(L, q));
  float* xw = sm + L.wp;
  float* yw = xw + round4(n);
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int i = tid + j * kThreads;
    if (i < n) {
      xw[i] = wx[j];
      yw[i] = wy[j];
    }
  }
  float* lam_x = sm + L.lam;
  float* lam_y = lam_x + round4(L.per);
  __syncthreads();
  // the first round's right-hand sides, in every CTA: alpha 0, d the
  // threshold, lam 0; pair n the first waypoint in both buffers, the
  // pairs past it 0.  Of the other buffer this writes only what no copy
  // does: the rows are written before any round reads them, and at an odd
  // n pair n comes with the last CTA's rows (so that no copy into this
  // CTA meets a write of its own)
  float2* rhs = reinterpret_cast<float2*>(sm + L.rhs);
  {
    const float c0 = cosf(0.0f), s0 = sinf(0.0f);
    const float dc = mul(a.thr, c0), ds = mul(a.thr, s0);
    for (int k = tid; k < L.P; k += kThreads) {
      float2 b = make_float2(0.0f, 0.0f);
      if (k < n) b = make_float2(add(0.0f, add(xw[k], dc)), add(0.0f, add(yw[k], ds)));
      else if (k == n) b = make_float2(xw[0], yw[0]);
      rhs[k] = b;
      if (k > n || (k == n && (n % 2 == 0 || r0 + rows == n))) rhs[L.P + k] = b;
    }
    for (int r = tid; r < L.per; r += kThreads) {
      lam_x[r] = 0.0f;
      lam_y[r] = 0.0f;
    }
  }
  __syncthreads();
  // this CTA's mbarriers and buffers ready for the others' copies
  cluster_arrive();

  if (count > 0) {
    // the warp's rows in its slab: into its registers
    wait_parity(copy_bar, 0);
    __syncwarp();
    load_group<TT>(ak, slab, count, n, L.T, base, step);
  }
  const unsigned copy_bytes = 8u * round2(rows);
  for (int it = 0; it < a.maxiter; ++it) {
    // ---- kh: wait
    const bool last = it + 1 == a.maxiter;
    const float2* cur = rhs + (it & 1) * L.P;
    float2* next = rhs + ((it + 1) & 1) * L.P;
    uint64_t* next_bar = buf_bar + ((it + 1) & 1);
    // this round's right-hand sides: the peers' rows copied in the round
    // before, counted on their buffer's mbarrier, and this CTA's own
    if (it > 0) wait_parity(buf_bar + (it & 1), ((it - 1) >> 1) & 1);
    if (tid == 0) mmd_async::mbar_expect(next_bar, rhs_bytes);
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
      // lane j the group's row j; the last round's pair is (x_s, y_s)
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
      if (lane < count) next[g] = make_float2(ox, oy);
    }
    // ---- kh: exchange
    // the CTA's rows of the other buffer into every peer's, once every
    // peer is ready for them (round 0): lanes 0 and 1 of warp w one bulk
    // copy each, to peers w and w + 8
    fence_proxy_async();
    __syncthreads();
    if (it == 0) cluster_wait();
    if (lane < kCluster / kWarps) {
      const int q = warp + lane * kWarps;
      if (q != rank)
        copy_to_peer(remote(next + r0, q), next + r0, copy_bytes, remote(next_bar, q));
    }
  }

  // ---- kh: path parameters
  // every row's x_s, y_s in this CTA's buffer
  wait_parity(buf_bar + (a.maxiter & 1), ((a.maxiter - 1) >> 1) & 1);
  const float2* gp = rhs + (a.maxiter & 1) * L.P;
  auto fx = [&](int j) { return j == 0 ? sub(gp[1].x, gp[0].x) : sub(gp[j].x, gp[j - 1].x); };
  auto fy = [&](int j) { return j == 0 ? sub(gp[1].y, gp[0].y) : sub(gp[j].y, gp[j - 1].y); };
  float* out = a.out;
  constexpr int kScanWarps = 2;
  if (rank == 0) {
    // ---- kh: scan
    // the arc length's increments of every row, from the same buffer, and
    // arc_vec[1 ..] their cumulative sum but the last (a scan's early
    // outputs do not depend on its later items); the critical path, so
    // CTA 0's own rows wait for it, on the warps past the scan's
    float* inc = sm + L.inc;
    for (int i = tid; i < n - 1; i += kThreads) {
      const float fxi = fx(i), fyi = fy(i);
      inc[i] = __fsqrt_rn(add(mul(fxi, fxi), mul(fyi, fyi)));
    }
    if (tid == 0) out[4 * n] = 0.0f;
    __syncthreads();
    mmd_order::cub_cumsum<kScanWarps>(inc, out + 4 * n + 1, n - 1, sm + L.total);
  }
  // its own rows' tangents, differences and curvature (CTA 0's on the
  // warps that do not scan)
  const int t0 = rank == 0 ? kScanWarps * kWarp : 0;
  for (int i = r0 + tid - t0; tid >= t0 && i < r0 + rows; i += kThreads - t0) {
    const float fxi = fx(i), fyi = fy(i);
    const float fxx = i == 0 ? sub(fx(1), fxi) : sub(fxi, fx(i - 1));
    const float fyy = i == 0 ? sub(fy(1), fyi) : sub(fyi, fy(i - 1));
    const float sq = add(mul(fxi, fxi), mul(fyi, fyi));
    out[i] = gp[i].x;
    out[n + i] = gp[i].y;
    out[2 * n + i] = fxi;
    out[3 * n + i] = fyi;
    out[5 * n + i] = __fdiv_rn(sub(mul(fyy, fxi), mul(fxx, fyi)), powf(sq, 1.5f));
  }
  // every copy out of this CTA's shared memory landed: each CTA arrives
  // once every copy into it has
  cluster_arrive();
  cluster_wait();
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
