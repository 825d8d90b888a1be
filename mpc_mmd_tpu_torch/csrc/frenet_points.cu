// Kernel (g): the on-road solve's Frenet conversions on one nearest-point
// search, an exact tile-pruned scan of the staged path, in three forms:
//   mmd_frenet_points     the rollouts' points (s, l), one launch an outer
//                         iteration (frenet.global_to_frenet_points);
//   mmd_frenet_states     the noisy initial states after their draw, one
//                         launch a solve (frenet.initial_states: the
//                         states, their Frenet states by
//                         global_to_frenet_state's arithmetic, the six
//                         means and the boundary rows b_eq_x, b_eq_y);
//   mmd_frenet_obstacles  the obstacles' (s, l, vs, vl, psi_rel), one
//                         launch a closed-loop step
//                         (frenet.global_to_frenet_obstacle), and their
//                         constant-velocity trajectories x_obs, y_obs
//                         (dynamics.constant_velocity_obstacles).
//
// Replaces what XLA fuses from the JAX package's conversions
// (mpc_mmd_tpu/frenet.py: _nearest :168, global_to_frenet_state :173,
// global_to_frenet_obstacle :210, global_to_frenet_points :229; called at
// solver_frenet.py:133-138 and :197 and closedloop.py:268), which the port
// ran as chains of PyTorch operations: two (points, path) distance buffers
// and an argmin, the gathers, interp's searchsorted, wheres and arithmetic
// (about 78 launches an outer iteration for the rollouts, about 200 a
// solve for the initial states, 141 a step for the obstacles).  Like
// kernels (a) to (f) it replaces an XLA lowering, not a Pallas kernel.
//
// Per point (x, y), against the path (x_path, y_path, Fx_dot, Fy_dot,
// arc_vec and, for the states and obstacles, kappa):
//   idx = argmin_j d_j, d_j = (x - x_j)^2 + (y - y_j)^2, the first index
//     of the least value, a NaN distance counting as least (torch.argmin);
//   s = arc_vec[idx];
//   tx, ty = interp(s, arc_vec, Fx_dot / Fy_dot) in frenet.interp's own
//     arithmetic (the right-side insertion point of s, PyTorch's binary
//     search, clipped to [1, n - 1]; the interval's slope; an interval no
//     wider than spacing(eps) taking its left value; both end clamps), one
//     search for both;
//   l = (-ty (x - x_idx) + tx (y - y_idx)) / sqrt(ty ty + tx tx).
// Every operation rounds on its own, as PyTorch's elementwise kernels do
// (__f*_rn: no contraction into fused multiply-adds; IEEE division and
// square root; atan2f, sinf and cosf as PyTorch's kernels call them; a
// tensor divided by a Python scalar is ATen's product with the float
// reciprocal; ** 2 is x * x), so that every output carries the chain's
// bits.
//
// The search.  The path is cut into tiles of kTile consecutive points,
// each with its bounding box (xmin, xmax, ymin, ymax).  A tile's lower
// bound for a point is lb = dx^2 + dy^2 with dx = x - xmax where x > xmax,
// xmin - x where x < xmin and 0 otherwise (dy alike), in the distance's
// own rounded operations.  Rounding to nearest is monotone and symmetric:
// for x > xmax >= x_j, fl(x - x_j) >= fl(x - xmax) >= 0 because x - x_j >=
// x - xmax; for x < xmin, |fl(x - x_j)| = fl(x_j - x) >= fl(xmin - x); a
// rounded square is monotone on non-negative values and a rounded sum in
// each term.  So lb <= d_j for every point j of the tile, with finite
// inputs (a distance is then finite or +inf, never NaN).  A tile is
// skipped only where its bound is strictly greater than the point's best
// distance so far: then every d_j there is greater than the best, and no
// point of the tile can win or tie (a tie at a lower index would win, so
// a bound equal to the best is visited).  The best is the least (d, j)
// under the lexicographic order, which does not depend on the order of
// the visits, and every point skipped is greater than it: the result is
// the full scan's.  Non-finite inputs take the full ordered scan with
// torch.argmin's NaN rule, in the same launch: a path with a non-finite
// coordinate (its NaN distances, a box that fminf / fmaxf would have
// dropped a NaN from, inf - inf) sends every point there, and a warp with
// a non-finite live point sends its 32.
//
// A warp takes 32 consecutive points (neighbouring time steps of one
// rollout, which lie close together).  It starts at the tile nearest the
// box of its points and walks outwards from it, one tile after the other
// on alternate sides; every lane computes its bound for the tile, and the
// warp skips the tile where no live lane needs it (__any_sync).  After
// the first tile one ballot, a lane a tile, marks the tiles whose gap to
// the warp's box is not greater than the largest best of a live lane, and
// the walk votes only on those: a lane's bound is at least the gap and
// its best only falls, so no other tile could pass the vote later.  In a
// visited tile every lane reads the same path points, shared-memory
// broadcasts of interleaved (x, y) pairs, and takes the tile's least
// distance on four independent fminf chains and its first index by a
// mask of the points at it, off the running best's dependent chain.  The
// bounds are branch-free (each difference's sign picks it).  One lane a
// point, tiles of 32: four lanes a point and tiles of 16 or 64 were
// slower on the closed loop's frame (PERF.md).
//
// Staging: thread 0 sends x_path and y_path into shared memory with TMA
// bulk copies onto one mbarrier, and Fx_dot, Fy_dot, arc_vec (and kappa)
// onto another (csrc/async_copy.cuh; the floats outside whole 16-byte
// blocks by the threads), while every thread loads its query point; the
// warps then interleave the points and box the tiles, a lane a point and
// shuffles a tile (a thread a tile, each reading its tile's 32 points in
// turn, took twice as long).  The second copy is waited for only after
// the search, before the interpolation that reads it.
//
// What bounds it on the card, at Path D (20,000 points, a path of 600):
// it reads 0.17 MB and writes 0.16 MB (0.10 us at 3.35 TB/s); its work is
// the pairs and bound checks these inputs need (chip_smoke.py counts them
// from the probe's visits: 5 operations a (point, path point) pair of a
// tile its warp visits and 7 a (point, tile) bound), 1.7e7 at about 4.6
// tiles a point, 0.26 us at 67 TFLOP/s.  The full scan did the 5 for
// every pair, 6e7 in all (0.9 us).  A CTA's thread 0 spends its cycles
// (kernel_ab's kg_clock) staging, searching and interpolating in turn,
// one warp a scheduler: the time is latency, not work.
// ops/frenet_points.py holds the twin of the search (nearest_pruned),
// whose tiles and visits are the kernel's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;                              // path points a tile, a lane each
constexpr int kWarps = 4;                              // warps a CTA (points, obstacles)
constexpr int kStateThreads = 256;                     // the state form's CTA
constexpr int kMaxWarps = 8;                           // warps a CTA, any form
constexpr int kMaxTiles = 224;                         // tiles of a path: 6,800 points
static_assert(kWarps <= kMaxWarps && kStateThreads / 32 <= kMaxWarps, "the need masks");
constexpr int kMaxStates = kStateThreads;              // a lane a state
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int tiles_of(int n) { return (n + kTile - 1) / kTile; }

// Shared memory of the staged path: two mbarriers (16 bytes), the tiles'
// boxes (16 bytes each), the interleaved points padded to whole tiles,
// then x_path, y_path, Fx_dot, Fy_dot, arc_vec and, with kappa, kappa (n
// each, rounded up to 16 bytes)
__host__ __device__ inline size_t path_bytes(int n, bool kappa) {
  const size_t t = tiles_of(n);
  return 16 + 16 * t + 8 * t * kTile + 4 * static_cast<size_t>(round4(n)) * (kappa ? 6 : 5);
}

struct Path {
  const float4* box;  // (xmin, xmax, ymin, ymax) of each tile's points
  const float2* xy;   // (x, y), +inf past the last point
  const float* fx;
  const float* fy;
  const float* arc;
  const float* kappa;
  uint64_t* bar;
  int n, tiles;
  bool finite;        // every path coordinate finite
};

struct PathArgs {
  const float *xp, *yp, *fx, *fy, *arc, *kappa;  // kappa null: not staged
  int n;
};

// the floats of a copy that TMA takes: whole 16-byte blocks of an aligned source
__device__ __forceinline__ int bulk_floats(const float* src, int n) {
  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (n & ~3) : 0;
}

// Stages the path (every thread of the block calls it): x_path and y_path
// by one bulk copy each onto the first mbarrier, waited for here, then
// the interleaved points and the boxes from shared memory; the tangents,
// the arc length and kappa onto the second, in flight until wait_path().
__device__ Path stage(char* smem, const PathArgs& a) {
  Path p;
  p.n = a.n;
  p.tiles = tiles_of(a.n);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  p.bar = bars + 1;
  float4* box = reinterpret_cast<float4*>(smem + 16);
  float2* xy = reinterpret_cast<float2*>(box + p.tiles);
  const int np = round4(a.n);
  // (every loop over the arrays unrolled: their pointers stay in registers)
  float* dst[6];
  dst[0] = reinterpret_cast<float*>(xy + p.tiles * kTile);
#pragma unroll
  for (int k = 1; k < 6; ++k) dst[k] = dst[k - 1] + np;
  const float* src[6] = {a.xp, a.yp, a.fx, a.fy, a.arc, a.kappa};
  const int arrays = a.kappa ? 6 : 5;
  if (threadIdx.x == 0) {
    mmd_async::mbar_init(&bars[0]);
    mmd_async::mbar_init(&bars[1]);
    mmd_async::mbar_fence_init();
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      unsigned bytes = 0;
#pragma unroll
      for (int k = g ? 2 : 0; k < (g ? 6 : 2); ++k)
        if (k < arrays) bytes += 4u * bulk_floats(src[k], a.n);
      mmd_async::mbar_expect(&bars[g], bytes);
#pragma unroll
      for (int k = g ? 2 : 0; k < (g ? 6 : 2); ++k) {
        const int b = k < arrays ? bulk_floats(src[k], a.n) : 0;
        if (b > 0) mmd_async::bulk_copy(dst[k], src[k], 4u * b, &bars[g]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (k < arrays)
      for (int j = bulk_floats(src[k], a.n) + threadIdx.x; j < a.n; j += blockDim.x)
        dst[k][j] = src[k][j];
  // the threads' tails seen by the block, the mbarriers' initialisation too
  __syncthreads();
  mmd_async::mbar_wait(&bars[0]);
  // the interleaved points and the boxes, a warp a tile, a lane a point
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  bool finite = true;
  for (int t = warp; t < p.tiles; t += warps) {
    const int j = t * kTile + lane;
    float px = INFINITY, py = INFINITY;
    float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY;
    if (j < a.n) {
      x0 = x1 = px = dst[0][j];
      y0 = y1 = py = dst[1][j];
      finite = finite && isfinite(px) && isfinite(py);
    }
    xy[j] = make_float2(px, py);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x0 = fminf(x0, __shfl_xor_sync(kFull, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, off));
      y0 = fminf(y0, __shfl_xor_sync(kFull, y0, off));
      y1 = fmaxf(y1, __shfl_xor_sync(kFull, y1, off));
    }
    if (lane == 0) box[t] = make_float4(x0, x1, y0, y1);
  }
  // the threads' stores seen by the block, the mbarrier's initialisation too
  p.finite = __syncthreads_and(finite);
  p.box = box;
  p.xy = xy;
  p.fx = dst[2];
  p.fy = dst[3];
  p.arc = dst[4];
  p.kappa = a.kappa ? dst[5] : nullptr;
  return p;
}

__device__ __forceinline__ void wait_path(const Path& p) { mmd_async::mbar_wait(p.bar); }

// the rounded squared distance of (x, y) to (px, py), as the chain forms it
__device__ __forceinline__ float dist2(float x, float y, float px, float py) {
  const float dx = __fsub_rn(x, px), dy = __fsub_rn(y, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// a tile's lower bound for (x, y): no point of the tile is nearer,
// rounded.  dx is x - xmax where x > xmax, xmin - x where x < xmin, else
// 0: the largest of the two rounded differences and 0 (a rounded
// difference has its exact value's sign; without branches)
__device__ __forceinline__ float tile_bound(float x, float y, float4 b) {
  const float dx = fmaxf(fmaxf(__fsub_rn(x, b.y), __fsub_rn(b.x, x)), 0.0f);
  const float dy = fmaxf(fmaxf(__fsub_rn(y, b.w), __fsub_rn(b.z, y)), 0.0f);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The least (distance, index) of the tile's points below `valid`: the
// least distance on four independent fminf chains (exact: fminf returns
// an operand), its first index by a mask of the points at it; with NANS
// (the full scan) a NaN distance first, the first NaN.  Without NANS, a
// finite (x, y) over a finite path: the tile's points past the path are
// at +inf, and a real point before them takes a tie.
template <bool NANS>
__device__ __forceinline__ void tile_min(const float2* q, int valid, float x, float y,
                                         float& least, int& first) {
  float d[kTile];
  float m0 = INFINITY, m1 = INFINITY, m2 = INFINITY, m3 = INFINITY;
#pragma unroll
  for (int k = 0; k < kTile; k += 4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = k + r;
      const float2 pt = q[i];
      d[i] = !NANS || i < valid ? dist2(x, y, pt.x, pt.y) : INFINITY;
    }
    m0 = fminf(m0, d[k]);   // (fminf passes over a NaN)
    m1 = fminf(m1, d[k + 1]);
    m2 = fminf(m2, d[k + 2]);
    m3 = fminf(m3, d[k + 3]);
  }
  least = fminf(fminf(m0, m1), fminf(m2, m3));
  unsigned at = 0, nan = 0;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    at |= static_cast<unsigned>(d[k] == least) << k;
    if (NANS) nan |= static_cast<unsigned>(d[k] != d[k]) << k;
  }
  if (NANS && nan) {
    at = nan;
    least = NAN;
  }
  first = __ffs(static_cast<int>(at)) - 1;
}

// The index of the path point nearest (x, y) under torch.argmin's rule,
// for the lanes with `live`; every lane of the warp calls it together, a
// lane a point.  *visits: the tiles the warp visited.
__device__ int nearest(const Path& p, float x, float y, bool live, int* visits) {
  const bool odd = live && !(isfinite(x) && isfinite(y));
  if (!p.finite || __any_sync(kFull, odd)) {
    // the full ordered scan, a tile at a time from tile 0: a NaN first
    // (the first NaN), then the least value, then the lower index
    float best;
    int idx;
    tile_min<true>(p.xy, min(kTile, p.n), x, y, best, idx);
    for (int t = 1; t < p.tiles; ++t) {
      float m;
      int i;
      tile_min<true>(p.xy + t * kTile, min(kTile, p.n - t * kTile), x, y, m, i);
      if ((m != m && best == best) || m < best) {
        best = m;
        idx = t * kTile + i;
      }
    }
    *visits = p.tiles;
    return idx;
  }
  // the box of the warp's live points; the tile nearest it (the lowest on a tie)
  float qx0 = live ? x : INFINITY, qx1 = live ? x : -INFINITY;
  float qy0 = live ? y : INFINITY, qy1 = live ? y : -INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qx0 = fminf(qx0, __shfl_xor_sync(kFull, qx0, off));
    qx1 = fmaxf(qx1, __shfl_xor_sync(kFull, qx1, off));
    qy0 = fminf(qy0, __shfl_xor_sync(kFull, qy0, off));
    qy1 = fmaxf(qy1, __shfl_xor_sync(kFull, qy1, off));
  }
  const int lane = threadIdx.x % 32;
  // tile t's gap to the box: no live lane's bound for it is smaller
  const auto gap_of = [&](int t) {
    const float4 b = p.box[t];
    const float gx = fmaxf(fmaxf(__fsub_rn(b.x, qx1), __fsub_rn(qx0, b.y)), 0.0f);
    const float gy = fmaxf(fmaxf(__fsub_rn(b.z, qy1), __fsub_rn(qy0, b.w)), 0.0f);
    return __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  };
  float gap = INFINITY;
  int first = 0x7fffffff;
  for (int t = lane; t < p.tiles; t += 32) {
    const float g = gap_of(t);
    if (g < gap || first == 0x7fffffff) {
      gap = g;
      first = t;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(kFull, gap, off);
    const int ot = __shfl_xor_sync(kFull, first, off);
    if (og < gap || (og == gap && ot < first)) {
      gap = og;
      first = ot;
    }
  }
  // outwards from it: first, first + 1, first - 1, first + 2, ...; the
  // first tile every live lane needs (its best is +inf)
  float best;
  int idx;
  tile_min<false>(p.xy + first * kTile, kTile, x, y, best, idx);
  idx += first * kTile;
  // the tiles that may still pass the vote below, a bit each, a lane a
  // tile: a tile whose gap to the box is greater than every live lane's
  // best cannot (a lane's bound is at least the gap, rounding being
  // monotone, and its best only falls).  The largest best by its bits: a
  // distance is +0 or more.
  const float worst = __uint_as_float(
      __reduce_max_sync(kFull, live ? __float_as_uint(best) : 0u));
  __shared__ unsigned need_bits[kMaxWarps][kMaxTiles / 32];
  unsigned* need = need_bits[threadIdx.x / 32];
  unsigned need0 = 0;
  for (int w = 0; 32 * w < p.tiles; ++w) {
    const int t = 32 * w + lane;
    const unsigned bits = __ballot_sync(kFull, t < p.tiles && !(gap_of(t) > worst));
    if (w == 0) need0 = bits;
    else if (lane == 0) need[w] = bits;
  }
  __syncwarp();
  int seen = 1;
  int lo = first - 1, hi = first + 1;
  for (int k = 1; k < p.tiles; ++k) {
    const bool up = hi < p.tiles && (lo < 0 || (k & 1));
    const int t = up ? hi++ : lo--;
    if (!(((t < 32 ? need0 : need[t / 32]) >> (t % 32)) & 1u)) continue;
    if (!__any_sync(kFull, live && !(tile_bound(x, y, p.box[t]) > best))) continue;
    ++seen;
    float m;
    int i;
    tile_min<false>(p.xy + t * kTile, kTile, x, y, m, i);
    i += t * kTile;
    if (m < best || (m == best && i < idx)) {
      best = m;
      idx = i;
    }
  }
  *visits = seen;
  return idx;
}

// PyTorch's searchsorted(right=True) on the card: the first index whose
// value is greater than v
__device__ __forceinline__ int upper_bound(const float* a, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(a[mid] > v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// frenet.interp(s, xp, fp) with i, s's insertion point clipped to [1, n -
// 1]: both sides of each of its wheres formed, then selected (no branch)
__device__ __forceinline__ float interp_at(float s, int i, const float* xp, const float* fp,
                                           int n, float tiny) {
  const float f0 = fp[i - 1];
  const float df = __fsub_rn(fp[i], f0);
  const float dx = __fsub_rn(xp[i], xp[i - 1]);
  const float delta = __fsub_rn(s, xp[i - 1]);
  const float slope = __fadd_rn(f0, __fmul_rn(__fdiv_rn(delta, dx), df));
  float f = fabsf(dx) <= tiny ? f0 : slope;
  f = s < xp[0] ? fp[0] : f;
  return s > xp[n - 1] ? fp[n - 1] : f;
}

__device__ __forceinline__ int insertion(const Path& p, float s) {
  return min(max(upper_bound(p.arc, p.n, s), 1), p.n - 1);
}

// _frame_at for one point: s, the tangent there, l; i is s's insertion point
struct Frame {
  float s, tx, ty, l;
  int i;
};

__device__ __forceinline__ Frame frame_at(const Path& p, int idx, float x, float y,
                                          float tiny) {
  Frame f;
  f.s = p.arc[idx];
  f.i = insertion(p, f.s);
  f.tx = interp_at(f.s, f.i, p.arc, p.fx, p.n, tiny);
  f.ty = interp_at(f.s, f.i, p.arc, p.fy, p.n, tiny);
  const float2 c = p.xy[idx];
  const float num = __fadd_rn(__fmul_rn(-f.ty, __fsub_rn(x, c.x)),
                              __fmul_rn(f.tx, __fsub_rn(y, c.y)));
  const float den = __fsqrt_rn(__fadd_rn(__fmul_rn(f.ty, f.ty), __fmul_rn(f.tx, f.tx)));
  f.l = __fdiv_rn(num, den);
  return f;
}

// _relative_heading: psi - atan2(ty, tx), wrapped by atan2(sin, cos)
__device__ __forceinline__ float relative_heading(float psi, float tx, float ty) {
  const float r = __fsub_rn(psi, atan2f(ty, tx));
  return atan2f(sinf(r), cosf(r));
}

// ---- the rollouts' points (FORM 0) and the obstacles (FORM 1) ----
constexpr int kPoints = 0;
constexpr int kObstacles = 1;

struct PointArgs {
  const float* x;    // points: x and y; obstacles: rows [x, y, vx, vy, psi]
  const float* y;
  float* s;
  float* l;
  float* more;       // obstacles: vs, vl, psi_rel (count each)
  int* idx;          // the probe's nearest index and visits, else null
  int* visits;
  int count;
  float tiny;
  const float* t;    // obstacles: the horizon's times (num), or null
  float* traj;       // obstacles: x_obs, y_obs (count, num) each
  int num;
};

// a live point's outputs from its nearest index; an obstacle's s, l, vs
// and vl also into sv (its trajectories' terms)
template <int FORM, bool PROBE>
__device__ __forceinline__ void point_out(const Path& p, const PointArgs& a, int q, int idx,
                                          int seen, float x, float y, float (&sv)[4]) {
  const Frame f = frame_at(p, idx, x, y, a.tiny);
  if (PROBE) {
    a.idx[q] = idx;
    a.visits[q] = seen;
  }
  a.s[q] = f.s;
  a.l[q] = f.l;
  if (FORM == kPoints) return;
  const float* row = a.x + 5 * q;
  const float vx = row[2], vy = row[3];
  const float v = __fsqrt_rn(__fadd_rn(__fmul_rn(vx, vx), __fmul_rn(vy, vy)));
  const float ki = interp_at(f.s, f.i, p.arc, p.kappa, p.n, a.tiny);
  const float psi_rel = relative_heading(row[4], f.tx, f.ty);
  const float den = __fsub_rn(1.0f, __fmul_rn(f.l, ki));
  const int m = a.count;
  const float vs = __fdiv_rn(__fmul_rn(v, cosf(psi_rel)), den);
  const float vl = __fmul_rn(v, sinf(psi_rel));
  a.more[q] = vs;
  a.more[m + q] = vl;
  a.more[2 * m + q] = psi_rel;
  sv[0] = f.s;
  sv[1] = f.l;
  sv[2] = vs;
  sv[3] = vl;
}

// The constant-velocity trajectories of the warp's live obstacles
// (dynamics.constant_velocity_obstacles): s + vs t and l + vl t, the
// product and the sum each rounded; an obstacle at a time, its times
// spread over the warp's lanes
__device__ __forceinline__ void trajectories(const PointArgs& a, int warp_first, bool live,
                                             const float (&sv)[4]) {
  const int lane = threadIdx.x % 32;
  for (unsigned m = __ballot_sync(kFull, live); m != 0u; m &= m - 1u) {
    const int src = __ffs(m) - 1, q = warp_first + src;
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __shfl_sync(kFull, sv[i], src);
    float* xo = a.traj + static_cast<long long>(q) * a.num;
    float* yo = xo + static_cast<long long>(a.count) * a.num;
    for (int k = lane; k < a.num; k += 32) {
      const float tk = a.t[k];
      xo[k] = __fadd_rn(o[0], __fmul_rn(o[2], tk));
      yo[k] = __fadd_rn(o[1], __fmul_rn(o[3], tk));
    }
  }
}

// (the "// ---- kg:" marks delimit the phases kernel_ab's kg_clock times)
template <int FORM, bool PROBE>
__global__ void __launch_bounds__(kWarps * 32)
frenet_points_kernel(PathArgs pa, PointArgs a) {
  // ---- kg: begin
  extern __shared__ __align__(16) char smem[];
  const int q = blockIdx.x * kWarps * 32 + threadIdx.x;
  const int warp_first = q - threadIdx.x % 32;
  const bool live = q < a.count;
  float x = 0.0f, y = 0.0f;
  if (live) {   // loaded while the path is staged
    x = FORM == kPoints ? a.x[q] : a.x[5 * q];
    y = FORM == kPoints ? a.y[q] : a.x[5 * q + 1];
  }
  const Path p = stage(smem, pa);
  // ---- kg: search
  if (warp_first >= a.count) return;        // a whole warp past the end
  int seen;
  const int idx = nearest(p, x, y, live, &seen);
  // ---- kg: wait
  wait_path(p);
  // ---- kg: outputs
  float sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) point_out<FORM, PROBE>(p, a, q, idx, seen, x, y, sv);
  if (FORM == kObstacles && a.t != nullptr) trajectories(a, warp_first, live, sv);
  // ---- kg: end
}

// ---- the initial states (one CTA) ----
struct StateArgs {
  const float* z;      // (n, 4) standard normals; columns 0 and 1 read
  const float* init;   // (6,) [x, y, v, vdot, psi, psidot]
  float* states;       // (n, 5) [x, y, vx, vy, psi]
  float* b_eq_x;       // (nb, 3) [s, vs, as]
  float* b_eq_y;       // (nb, 4) [l, vl, al, 0]
  int* idx;            // the probe's, else null
  int* visits;
  int n, nb;
  float mu0, mu1, sig0, sig1, inv_n, tiny;
};

__host__ __device__ constexpr int last_pow2(int n) {
  return n >= 64 ? 64 : n >= 32 ? 32 : n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
}

// The sum of the n floats t[0 .. n-1] of a contiguous 1-d tensor whose
// first element is 16-byte aligned, as ATen reduces it to one output on
// the card (Reduce.cuh), by one warp, every lane getting it.  One output
// leaves the block all its width (set_block_dimension): W = 2^floor(log2
// n) threads, of n / 4 vectors from n = 128 on (at most 64 for n <= 256);
// thread x puts terms x + i W (vectors: vector v = x, x + W, ... element i,
// the tail element 4 (n / 4) + x) each into accumulator i from +0, the
// four added in order; block_x_reduce then adds thread x + 32 into thread
// x where W = 64 (through shared memory), and shuffles down at W / 2 ...
// 1 (at most 16).  torch_order.cuh's row_reduce is the same order for a
// row of a tensor of many rows, whose width stays within a warp.
__device__ float aten_sum(const float* t, int n, int lane) {
  const bool vec = n >= 128;
  const int W = last_pow2(vec ? n / 4 : n);
  float part[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = lane + 32 * h;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (x < W) {
      if (vec) {
        const int nvec = n / 4;
        for (int v = x; v < nvec; v += W) {
          a0 = __fadd_rn(a0, t[4 * v]);
          a1 = __fadd_rn(a1, t[4 * v + 1]);
          a2 = __fadd_rn(a2, t[4 * v + 2]);
          a3 = __fadd_rn(a3, t[4 * v + 3]);
        }
        if (x < n % 4) a0 = __fadd_rn(a0, t[4 * nvec + x]);
      } else {
        if (x < n) a0 = __fadd_rn(0.0f, t[x]);
        if (x + W < n) a1 = __fadd_rn(0.0f, t[x + W]);
        if (x + 2 * W < n) a2 = __fadd_rn(0.0f, t[x + 2 * W]);
        if (x + 3 * W < n) a3 = __fadd_rn(0.0f, t[x + 3 * W]);
      }
    }
    part[h] = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
  }
  float s = part[0];
  int width = W;
  if (W > 32) {
    s = __fadd_rn(s, part[1]);
    width = 32;
  }
  for (int off = width / 2; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_down_sync(kFull, s, off));
  return __shfl_sync(kFull, s, 0);
}

template <bool PROBE>
__global__ void __launch_bounds__(kStateThreads)
frenet_states_kernel(PathArgs pa, StateArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ __align__(16) float conv[6][kMaxStates];   // s, l, vs, vl, as, al
  __shared__ __align__(16) float mean[8];
  const int q = threadIdx.x, lane = q % 32;
  const bool live = q < a.n;
  // FrenetSolver's states: (x, y) perturbed, the ego's velocity and
  // heading (loaded and formed while the path is staged)
  const float xg = a.init[0], yg = a.init[1], vg = a.init[2], vdot = a.init[3],
              psig = a.init[4], psidot = a.init[5];
  const float vxg = __fmul_rn(vg, cosf(psig)), vyg = __fmul_rn(vg, sinf(psig));
  float x = 0.0f, y = 0.0f;
  if (live) {
    x = __fadd_rn(__fadd_rn(xg, __fmul_rn(a.z[4 * q], a.sig0)), a.mu0);
    y = __fadd_rn(__fadd_rn(yg, __fmul_rn(a.z[4 * q + 1], a.sig1)), a.mu1);
  }
  const Path p = stage(smem, pa);
  int idx = 0, seen = 0;
  if (q - lane < a.n) idx = nearest(p, x, y, live, &seen);
  wait_path(p);
  if (live) {
    const float psi = atan2f(vyg, vxg);
    float* st = a.states + 5 * q;
    st[0] = x;
    st[1] = y;
    st[2] = vxg;
    st[3] = vyg;
    st[4] = psi;
    if (PROBE) {
      a.idx[q] = idx;
      a.visits[q] = seen;
    }
    // global_to_frenet_state of [x, y, v, vdot, psi, psidot]
    const float v = __fsqrt_rn(__fadd_rn(__fmul_rn(vxg, vxg), __fmul_rn(vyg, vyg)));
    const Frame f = frame_at(p, idx, x, y, a.tiny);
    const float ki = interp_at(f.s, f.i, p.arc, p.kappa, p.n, a.tiny);
    const float sp = __fadd_rn(f.s, 0.001f);
    const float kp = interp_at(sp, insertion(p, sp), p.arc, p.kappa, p.n, a.tiny);
    // ATen's quotient by a Python scalar: the product with its float reciprocal
    const float kprime = __fmul_rn(__fsub_rn(kp, ki), __fdiv_rn(1.0f, 0.001f));
    const float psi_rel = relative_heading(psi, f.tx, f.ty);
    const float c = cosf(psi_rel), sn = sinf(psi_rel);
    const float den = __fsub_rn(1.0f, __fmul_rn(f.l, ki));
    const float vc = __fmul_rn(v, c);
    const float vs = __fdiv_rn(vc, den);
    const float vl = __fmul_rn(v, sn);
    const float psidot_rel = __fsub_rn(psidot, __fmul_rn(ki, vs));
    const float al = __fadd_rn(__fmul_rn(vdot, sn), __fmul_rn(vc, psidot_rel));
    const float as_p1 = __fsub_rn(__fmul_rn(vdot, c), __fmul_rn(__fmul_rn(v, sn), psidot_rel));
    const float as_p2 = __fsub_rn(__fmul_rn(-vl, ki), __fmul_rn(__fmul_rn(f.l, kprime), vs));
    const float as_ = __fdiv_rn(__fsub_rn(__fmul_rn(as_p1, den), __fmul_rn(vc, as_p2)),
                                __fmul_rn(den, den));
    conv[0][q] = f.s;
    conv[1][q] = f.l;
    conv[2][q] = vs;
    conv[3][q] = vl;
    conv[4][q] = as_;
    conv[5][q] = al;
  }
  __syncthreads();
  // the six means, c.sum() * (1 / n), a warp each
  const int warp = q / 32;
  if (warp < 6) {
    const float sum = aten_sum(conv[warp], a.n, lane);
    if (lane == 0) mean[warp] = __fmul_rn(sum, a.inv_n);
  }
  __syncthreads();
  for (int e = q; e < 7 * a.nb; e += kStateThreads) {
    const int r = e / 7, c = e % 7;
    if (c < 3) a.b_eq_x[3 * r + c] = mean[c == 0 ? 0 : c == 1 ? 2 : 4];
    else a.b_eq_y[4 * r + c - 3] = c == 6 ? 0.0f : mean[c == 3 ? 1 : c == 4 ? 3 : 5];
  }
}

// static shared memory: the search's need masks (the points and obstacle
// forms), and with conv and mean (the state form)
constexpr size_t kSearchStatic = 4 * kMaxWarps * (kMaxTiles / 32) + 64;
constexpr size_t kStateStatic = sizeof(float) * 7 * kMaxStates;
static_assert(kStateStatic >= sizeof(float) * (6 * kMaxStates + 8) + kSearchStatic, "");

// once per kernel: past the 48 KB default of dynamic shared memory
template <class K>
int opt_in(K kernel, size_t bytes, bool& opted) {
  if (opted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  opted = true;
  return 0;
}

template <int FORM, bool PROBE>
int launch_points(const PathArgs& pa, const PointArgs& a, void* stream) {
  if (a.count <= 0) return 0;
  const size_t smem = path_bytes(pa.n, pa.kappa != nullptr);
  if (pa.n < 2 || tiles_of(pa.n) > kMaxTiles || smem > kMaxSmem - kSearchStatic)
    return cudaErrorInvalidValue;
  static bool opted = false;
  const int e = opt_in(frenet_points_kernel<FORM, PROBE>, kMaxSmem - kSearchStatic, opted);
  if (e) return e;
  constexpr int per = kWarps * 32;
  frenet_points_kernel<FORM, PROBE><<<(a.count + per - 1) / per, per, smem,
                                      static_cast<cudaStream_t>(stream)>>>(pa, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool PROBE>
int launch_states(const PathArgs& pa, const StateArgs& a, void* stream) {
  const size_t smem = path_bytes(pa.n, true);
  if (a.n < 1 || a.n > kMaxStates || a.nb < 0 || pa.n < 2 || tiles_of(pa.n) > kMaxTiles ||
      smem > kMaxSmem - kStateStatic)
    return cudaErrorInvalidValue;
  static bool opted = false;
  const int e = opt_in(frenet_states_kernel<PROBE>, kMaxSmem - kStateStatic, opted);
  if (e) return e;
  frenet_states_kernel<PROBE><<<1, kStateThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pa, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes idx and visits, the probe's: each point's nearest
// index and the tiles its warp visited (tests and chip_smoke.py), or null.
// tiny: frenet.interp's spacing(eps) bound on an interval's width.
template <int FORM>
int launch_form(const PathArgs& pa, const PointArgs& a, void* stream) {
  return a.idx ? launch_points<FORM, true>(pa, a, stream)
               : launch_points<FORM, false>(pa, a, stream);
}

// x, y, s, l, idx, visits (points,)
extern "C" int mmd_frenet_points(const float* x, const float* y, const float* x_path,
                                 const float* y_path, const float* fx, const float* fy,
                                 const float* arc, float* s, float* l, int* idx, int* visits,
                                 int points, int n, float tiny, void* stream) {
  const PathArgs pa = {x_path, y_path, fx, fy, arc, nullptr, n};
  return launch_form<kPoints>(
      pa, {x, y, s, l, nullptr, idx, visits, points, tiny, nullptr, nullptr, 0}, stream);
}

// obs (m, 5) rows [x, y, vx, vy, psi]; out (5, m): s, l, vs, vl, psi_rel;
// idx, visits (m,); t (num,) the horizon's times and traj (2, m, num)
// x_obs, y_obs, or both null
extern "C" int mmd_frenet_obstacles(const float* obs, const float* x_path,
                                    const float* y_path, const float* fx, const float* fy,
                                    const float* arc, const float* kappa, float* out, int* idx,
                                    int* visits, const float* t, float* traj, int num, int m,
                                    int n, float tiny, void* stream) {
  if ((t == nullptr) != (traj == nullptr) || (t != nullptr && num < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const PathArgs pa = {x_path, y_path, fx, fy, arc, kappa, n};
  return launch_form<kObstacles>(
      pa, {obs, nullptr, out, out + m, out + 2 * m, idx, visits, m, tiny, t, traj, num}, stream);
}

// z (n, 4), init (6,); states (n, 5), b_eq_x (nb, 3), b_eq_y (nb, 4);
// idx, visits (n,)
extern "C" int mmd_frenet_states(const float* z, const float* init, const float* x_path,
                                 const float* y_path, const float* fx, const float* fy,
                                 const float* arc, const float* kappa, float* states,
                                 float* b_eq_x, float* b_eq_y, int* idx, int* visits, int n,
                                 int nb, int path_n, float mu0, float mu1, float sig0,
                                 float sig1, float inv_n, float tiny, void* stream) {
  const PathArgs pa = {x_path, y_path, fx, fy, arc, kappa, path_n};
  const StateArgs a = {z, init, states, b_eq_x, b_eq_y, idx, visits, n, nb,
                       mu0, mu1, sig0, sig1, inv_n, tiny};
  return idx ? launch_states<true>(pa, a, stream) : launch_states<false>(pa, a, stream);
}
