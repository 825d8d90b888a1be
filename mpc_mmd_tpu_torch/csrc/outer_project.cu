// Kernel (d): the guess QP, the AM projection and the controls of every
// candidate row of an outer CEM iteration in one launch.
//
// Replaces what XLA fuses from the JAX package's outer iteration
// (mpc_mmd_tpu/solver.py:190-200: compute_guess, qp.py:164; project,
// projection.py:104 with its AM rounds; controls_from_trajectory,
// dynamics.py:142), which the port ran as about 240 PyTorch launches an
// outer iteration (ops/outer_project.py's plain version: qp.compute_guess,
// projection.project, dynamics.controls_from_trajectory).  Like kernels
// (a), (b) and (c) it replaces an XLA lowering, not a Pallas kernel.
//
// Per row (a candidate: params (8), the boundary rows b_eq_x (3), b_eq_y
// (4), the carried lamda_x, lamda_y (nvar) and s_lane (2 (num - 1))):
//   the guess: lincost = [V | Y] @ G (V, Y the parameters' halves), the
//   coefficients c_bar the first nvar of K_guess^-1 [-lincost; b_eq];
//   the projection's polar initialisation of the guess's velocity and
//   acceleration (atan2, unwrapped along time, the clipped radius) and the
//   multipliers' pre-update; `maxiter` AM rounds: the KKT solves with the
//   prefactored inverses, x, y and their derivatives, the lane slack, the
//   polar re-estimate, res_norm (three 2-norms) and the multiplier
//   update; on the path (arc_vec, kappa) the curvature under each step
//   (a search over arc_vec) and the curvature-coupled steering;
//   the controls: acc the forward difference of the speed over dt (0 at
//   the end), steer = atan(curvature L).
//
// The obstacle-active form (the OBS template argument: the JAX package's
// with_obstacle_terms projection, projection.py:150-260, which the det
// baseline runs) adds, per step and obstacle block, the displacement of
// the trajectory from the obstacle, its polar step (the angle atan2(wy a,
// wx b), the radius clamped below by 1 for the guess and by d_floor, the
// radius one step earlier scaled by 1 - gamma_obs, in each round), the
// residuals and the blocks' sums through P^T: into the multipliers'
// pre-update and each round's update, the obstacle rows of each round's
// linear cost, and the norm of the concatenated residuals added to
// res_norm.  A row stages its scenario's obstacles, keeps its radii (two
// buffers, for the shift across the steps) and residuals in shared
// memory, and its block sums join the pass's chains.
//
// The arithmetic follows the plain chain on the card operation for
// operation, so that the kernel gives its bits: every product
// (linalg.scenario_mm, a batched cuBLAS GEMM at half a scenario's rows) is
// a chain of fused multiply-adds from 0 in the order of the shared axis,
// which is what cuBLAS's FFMA kernels (sm80_xmma_gemm_f32f32..._ffma,
// tiles of 32 x 32 x 8) compute at every product shape of the guess QP and
// the projection at 32 and 50 rows (a probe of every element on the H100);
// the three norms in PyTorch's vectorised order (torch_order.cuh); every
// elementwise step with its own rounding (the __f*_rn intrinsics: no
// contraction into fused multiply-adds); atan2f, cosf, sinf, atanf, powf
// and fmodf as PyTorch's kernels call them (no fast-math), each angle's
// cosine and sine taken once and used wherever the chain takes them of the
// same angle; a tensor over a Python float as a product with the float32
// reciprocal; unwrap's cumulative sum of the 2 pi corrections as
// torch.cumsum's scan_innermost_dim adds them (blocks of 2 X columns, X set
// by the launch's rows and the row length, each block's first element
// plus the blocks before it, then Sklansky's levels within the block).
//
// What bounds it on the card: per launch it reads the rows' inputs and
// about 26 KB of shared matrices and writes 13 rows of num floats a row
// (0.34 MB at fastrt's 64 rows): 0.1 us of memory.  Its work is about 25
// products of 100 x 11 a row and round 10 transcendental calls a step:
// 2e7 float operations at 64 rows, 0.3 us.  What bounds it instead is the
// latency of a row's chain of dependent phases (guess, polar step, the
// KKT products, the norms, the multiplier chains of num and 2 (num - 1)
// fused multiply-adds a coefficient).  The design shortens that chain:
//   - a row is a warpgroup (128 threads): a time step a thread, two lane
//     rows a thread, one multiplier or right-hand-side chain a thread, the
//     three norms one warp each; one or two rows a CTA (named barriers a
//     row), so that 64 rows run on 64 or 32 SMs;
//   - the multipliers' update of a round and the next round's right-hand
//     sides read the same polar estimate, so their 10 nvar chains run in
//     one pass (maxiter + 1 passes a launch, not 2 maxiter + 1);
//   - the path shapes (nvar 11, num 100, 4 segments) are compile-time: the
//     chains unroll, their loads from shared memory issue ahead of the
//     fused multiply-adds, the trajectory's coefficients sit in registers;
//     other shapes take the run-time-shape instantiation of the same code;
//   - one thread stages the shared matrices (and the path) with TMA bulk
//     copies onto two mbarriers, the guess's four first, while the row's
//     threads read their inputs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "torch_order.cuh"

namespace {

using mmd_order::clamp;
using mmd_order::clamp_min;
using mmd_order::kFull;
using mmd_order::minimum;
using mmd_order::Square;

constexpr int kWarp = 32;
constexpr int kRowThreads = 128;  // a row's warpgroup: a time step a thread
constexpr int kMaxNum = kRowThreads;
constexpr int kMaxNvar = 16;
constexpr int kMaxSeg = 8;
constexpr int kCo = kMaxNvar + 4;  // a coefficient buffer (a KKT right-hand side)
constexpr int kMaxSmem = 232448 - 1024;  // dynamic: the card's 227 KB less the static
constexpr int kMaxPathStaged = 8192;  // path points staged in shared memory
// the compile-time shape: nvar, num, segments
constexpr int kNvar = 11, kNum = 100, kSeg = 4;
// np.float32(2 pi) and its half, unwrap's period and interval
constexpr float kPeriod = 6.2831854820251464844f;
constexpr float kInterval = 3.1415927410125732422f;
// float(np.spacing(np.finfo(np.float32).eps)): interp's degenerate interval
constexpr float kTinyDx = 1.4210854715202004e-14f;

struct Args {
  const float *params, *b_eq_x, *b_eq_y, *lamda_x0, *lamda_y0, *s_lane0;
  const float *G_vx, *G_py, *Gix, *Giy, *P, *Pd, *Pdd, *Al, *Kix, *Kiy;
  const float *arc, *kap;
  float *c_x, *c_y, *x, *y, *xdot, *ydot, *xddot, *yddot, *res_norm, *lamda_x, *lamda_y,
      *s_lane, *steering, *kappa_interp, *acc, *steer;
  int rows, nvar, num, nseg, maxiter, npath, path_staged;
  int scan_block;  // torch.cumsum's block of columns at these rows (cumsum_block)
  float rho_ineq, rho_proj, rho_lane, lane_ub, lane_lb, v_min, v_max, a_max, inv_dt,
      wheel_base;
  // the obstacle-active form: the scenarios' obstacles (rows / per_scen,
  // nblk, num), and rho_obs, a_obs, b_obs, a_obs^2, b_obs^2, 1 - gamma_obs
  const float *x_obs, *y_obs;
  int nblk, per_scen;
  float rho_obs, a_obs, b_obs, a2_obs, b2_obs, g_obs;
};

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// shared floats, every block 16-byte aligned: the ten matrices and the
// staged path, then per row the residual vectors rv (ax | ay | vx | vy,
// each numv), the b vectors bv, unwrap's scratch uw (4 numv), the lane
// residual rl and lane b vector bl, the coefficient buffers and the norms;
// in the obstacle-active form (nblk blocks) also the row's obstacles xo,
// yo (nblk num each), its radii in two buffers d, the residuals ro (x
// blocks | y blocks) and the block sums of the residuals rvo and of the b
// vectors bvo (x | y, numv each)
struct Smem {
  int mat[10], arc, kap, mats, numv, nlv, rv, bv, uw, rl, bl, co, nrm, xo, yo, d, ro, rvo, bvo,
      per_row, total;
};

__host__ __device__ inline Smem smem_layout(int nvar, int num, int nseg, int npath_staged,
                                            int rows, int nblk = 0) {
  Smem s{};
  const int nl = 2 * (num - 1), nx = nvar + 3, ny = nvar + 4;
  const int n[10] = {nseg * nvar, nseg * nvar, nx * nx, ny * ny, num * nvar,
                     num * nvar,  num * nvar,  nl * nvar, nx * nx, ny * ny};
  int o = 0;
  for (int m = 0; m < 10; ++m) {
    s.mat[m] = o;
    o += pad4(n[m]);
  }
  s.arc = o; o += pad4(npath_staged);
  s.kap = o; o += pad4(npath_staged);
  s.mats = o;
  s.numv = pad4(num);
  s.nlv = pad4(nl);
  int q = 0;
  s.rv = q; q += 4 * s.numv;
  s.bv = q; q += 4 * s.numv;
  s.uw = q; q += 4 * s.numv;
  s.rl = q; q += s.nlv;
  s.bl = q; q += s.nlv;
  s.co = q; q += (nblk > 0 ? 22 : 18) * kCo;
  s.nrm = q; q += 4;
  if (nblk > 0) {
    const int bn = pad4(nblk * num);
    s.xo = q; q += bn;
    s.yo = q; q += bn;
    s.d = q; q += 2 * bn;
    s.ro = q; q += pad4(2 * nblk * num);
    s.rvo = q; q += 2 * s.numv;
    s.bvo = q; q += 2 * s.numv;
  }
  s.per_row = q;
  s.total = o + rows * q;
  return s;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ---- TMA bulk copies onto an mbarrier (async_copy.cuh) ----
using mmd_async::bulk_copy;
using mmd_async::mbar_expect;
using mmd_async::mbar_fence_init;
using mmd_async::mbar_init;
using mmd_async::mbar_wait;
// the floats of a copy that TMA takes: whole 16-byte blocks of an aligned source
__device__ __forceinline__ int bulk_floats(const float* src, int n) {
  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (n & ~3) : 0;
}

// the barrier of a row's warpgroup (named barrier 1 + row)
__device__ __forceinline__ void row_sync(int row) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(row + 1) : "memory");
}

// sum_k v[k] m[k stride] as fused multiply-adds from 0, k ascending: one
// output of a product as cuBLAS's FFMA kernels take it.  K, S > 0: the
// compile-time chain, v 16-byte aligned and read four floats at a time;
// else K and S at run time.
template <int K, int S>
__device__ __forceinline__ float chain(const float* v, const float* m, int k_rt, int s_rt) {
  float acc = 0.0f;
  if constexpr (K > 0) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 x = v4[q];
      acc = __fmaf_rn(x.x, m[(4 * q) * S], acc);
      acc = __fmaf_rn(x.y, m[(4 * q + 1) * S], acc);
      acc = __fmaf_rn(x.z, m[(4 * q + 2) * S], acc);
      acc = __fmaf_rn(x.w, m[(4 * q + 3) * S], acc);
    }
#pragma unroll
    for (int k = K / 4 * 4; k < K; ++k) acc = __fmaf_rn(v[k], m[k * S], acc);
  } else {
#pragma unroll 4
    for (int k = 0; k < k_rt; ++k) acc = __fmaf_rn(v[k], m[k * s_rt], acc);
  }
  return acc;
}

// the same chain with v read a float at a time (v in registers, or short)
template <int K, int S>
__device__ __forceinline__ float chain_s(const float* v, const float* m, int k_rt, int s_rt) {
  float acc = 0.0f;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc = __fmaf_rn(v[k], m[k * S], acc);
  } else {
#pragma unroll 4
    for (int k = 0; k < k_rt; ++k) acc = __fmaf_rn(v[k], m[k * s_rt], acc);
  }
  return acc;
}

// torch.remainder of a by b > 0 on the card
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

// The polar step of (wx, wy) at an angle of cosine c and sine s: the
// clipped radius
__device__ __forceinline__ float radius(float wx, float wy, float c, float s, float rho, float lo,
                                        float hi) {
  const float c1 = mul(rho, add(mul(c, c), mul(s, s)));
  const float c2 = mul(rho, add(mul(wx, c), mul(wy, s)));
  return clamp(__fdiv_rn(c2, c1), lo, hi);
}

// unwrap's correction between the angles a0 and a1 of two steps
__device__ __forceinline__ float unwrap_step(float a0, float a1) {
  const float dd = sub(a1, a0);
  float ddmod = sub(remainder(add(dd, kInterval), kPeriod), kInterval);
  if (ddmod == -kInterval && dd > 0.0f) ddmod = kInterval;
  return fabsf(dd) < kInterval ? 0.0f : sub(ddmod, dd);
}

constexpr int kChunks = kMaxNum / kWarp;  // a row's steps in chunks of a warp

// cum[0 .. n), n <= 128: the corrections, in place their inclusive
// cumulative sum in torch.cumsum's order on the card for the rows of a
// (rows, n) tensor (ATen's scan_innermost_dim: torch_order.cuh's
// scan_innermost), by one warp, four chunks of 32 in registers.  Where at
// most two corrections are not zero every order gives the same sums (an added +0 leaves a sum's bits, and the corrections are
// never -0), so those are added left to right: the scan in every row gives
// the same bits, but a launch up to 15 % longer (utils/kernel_ab.py --kernels
// kd on an H100).
__device__ void aten_cumsum(float* cum, int n, int B, int lane) {
  float v[kChunks];
  int nonzero = 0;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + j * kWarp;
    v[j] = i < n ? cum[i] : 0.0f;
    nonzero += __popc(__ballot_sync(kFull, v[j] != 0.0f));
  }
  if (nonzero <= 2) {
    float run = 0.0f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      float mine = run;
      for (unsigned m = __ballot_sync(kFull, v[j] != 0.0f); m != 0u; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        run = add(run, __shfl_sync(kFull, v[j], b));
        if (lane >= b) mine = run;
      }
      v[j] = mine;
    }
  } else {
    mmd_order::scan_innermost(v, B, lane);
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + j * kWarp;
    if (i < n) cum[i] = v[j];
  }
}

// jnp.interp / frenet.interp of x in the increasing xp with values fp (n)
__device__ float interp(float x, const float* xp, const float* fp, int n) {
  int lo = 0, hi = n;  // searchsorted(xp, x, right=True)
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(xp[mid] > x)) lo = mid + 1;
    else hi = mid;
  }
  const int i = lo < 1 ? 1 : lo > n - 1 ? n - 1 : lo;
  const float df = sub(fp[i], fp[i - 1]);
  const float dx = sub(xp[i], xp[i - 1]);
  const float delta = sub(x, xp[i - 1]);
  const bool dx0 = fabsf(dx) <= kTinyDx;
  float f = dx0 ? fp[i - 1] : add(fp[i - 1], mul(__fdiv_rn(delta, dx), df));
  if (x < xp[0]) f = fp[0];
  if (x > xp[n - 1]) f = fp[n - 1];
  return f;
}

// NV, NUM, NSEG: the compile-time shape, or all 0 for the run-time shape;
// ROWS rows a CTA, a warpgroup each; OBS the obstacle-active form
template <int NV, int NUM, int NSEG, int ROWS, bool OBS>
__global__ void __launch_bounds__(ROWS* kRowThreads) outer_project_kernel(const Args a) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) uint64_t bars[2];
  const int nvar = NV ? NV : a.nvar, num = NUM ? NUM : a.num, nseg = NSEG ? NSEG : a.nseg;
  const int nl = 2 * (num - 1), nx = nvar + 3, ny = nvar + 4;
  constexpr int NL = NUM ? 2 * (NUM - 1) : 0;
  const int npath = a.npath, staged = a.path_staged ? npath : 0;
  const int nblk = OBS ? a.nblk : 0;
  const Smem L = smem_layout(nvar, num, nseg, staged, ROWS, nblk);
  const int row = threadIdx.x / kRowThreads, tid = threadIdx.x % kRowThreads;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int r = blockIdx.x * ROWS + row;
  const bool live = r < a.rows;

  // ---- staging: TMA bulk copies of the matrices (the guess's four on
  // bars[0], the rest and the path on bars[1]); their tails and any
  // unaligned source by the threads ----
  const float* src[12] = {a.G_vx, a.G_py, a.Gix, a.Giy, a.P,  a.Pd,
                          a.Pdd,  a.Al,   a.Kix, a.Kiy, a.arc, a.kap};
  const int n[12] = {nseg * nvar, nseg * nvar, nx * nx, ny * ny, num * nvar, num * nvar,
                     num * nvar,  nl * nvar,   nx * nx, ny * ny, staged,     staged};
  int off[12];
  for (int m = 0; m < 10; ++m) off[m] = L.mat[m];
  off[10] = L.arc;
  off[11] = L.kap;
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    mbar_fence_init();
    for (int g = 0; g < 2; ++g) {
      const int m0 = g == 0 ? 0 : 4, m1 = g == 0 ? 4 : 12;
      unsigned bytes = 0;
      for (int m = m0; m < m1; ++m) bytes += 4u * bulk_floats(src[m], n[m]);
      mbar_expect(&bars[g], bytes);
      for (int m = m0; m < m1; ++m) {
        const int k = bulk_floats(src[m], n[m]);
        if (k > 0) bulk_copy(sm + off[m], src[m], 4u * k, &bars[g]);
      }
    }
  }
  for (int m = 0; m < 12; ++m)
    for (int i = bulk_floats(src[m], n[m]) + threadIdx.x; i < n[m]; i += ROWS * kRowThreads)
      sm[off[m] + i] = src[m][i];

  // the row's inputs, read while the copies fly
  float* rb_ = sm + L.mats + row * L.per_row;
  float *rv = rb_ + L.rv, *bv = rb_ + L.bv, *uw = rb_ + L.uw, *rl = rb_ + L.rl, *bl = rb_ + L.bl;
  float* co = rb_ + L.co;
  float *cxb = co, *cyb = co + kCo, *cx = co + 2 * kCo, *cy = co + 3 * kCo;
  float *rx = co + 4 * kCo, *ry = co + 5 * kCo;
  float* mres = co + 6 * kCo;   // 5 x kCo: the multiplier contractions
  float* bres = co + 11 * kCo;  // 5 x kCo: the right-hand sides' contractions
  float* flags = co + 16 * kCo;  // unwrap's: a correction in av, in aa
  float* ores = co + 18 * kCo;  // 4 x kCo: the obstacle blocks' (residual x, y; b x, y)
  float* nrm = rb_ + L.nrm;
  float *xo = rb_ + L.xo, *yo = rb_ + L.yo, *ro = rb_ + L.ro, *rvo = rb_ + L.rvo;
  float* bvo = rb_ + L.bvo;
  const int numv = L.numv;
  const int lrow0 = tid, lrow1 = tid + kRowThreads;  // this thread's lane rows
  const float b_lane0 = lrow0 < num - 1 ? a.lane_ub : a.lane_lb;
  const float b_lane1 = lrow1 < num - 1 ? a.lane_ub : a.lane_lb;
  float prm[2 * kMaxSeg];
  float lxy = 0.0f, sl0 = 0.0f, sl1 = 0.0f, beq = 0.0f;
  if (live) {
    const float* p = a.params + static_cast<size_t>(r) * 2 * nseg;
    const int half = tid < kWarp ? 0 : nseg;  // warp 0 the x half, warp 1 the y half
    if (tid < 2 * kWarp)
#pragma unroll
      for (int k = 0; k < (NSEG ? NSEG : kMaxSeg); ++k)
        if (NSEG || k < nseg) prm[k] = p[half + k];
    if (tid < nvar) lxy = a.lamda_x0[r * nvar + tid];
    if (tid >= kWarp && tid < kWarp + nvar) lxy = a.lamda_y0[r * nvar + tid - kWarp];
    if (tid >= 64 && tid < 67) beq = a.b_eq_x[r * 3 + tid - 64];
    if (tid >= 96 && tid < 100) beq = a.b_eq_y[r * 4 + tid - 96];
    if (lrow0 < nl) sl0 = a.s_lane0[static_cast<size_t>(r) * nl + lrow0];
    if (lrow1 < nl) sl1 = a.s_lane0[static_cast<size_t>(r) * nl + lrow1];
    if (tid == 0) flags[0] = flags[1] = 0.0f;
    if constexpr (OBS) {  // the row's scenario's obstacles: a step a thread
      const size_t ob = static_cast<size_t>(r / a.per_scen) * nblk * num;
      if (tid < num)
        for (int o = 0; o < nblk; ++o) {
          xo[o * num + tid] = a.x_obs[ob + o * num + tid];
          yo[o * num + tid] = a.y_obs[ob + o * num + tid];
        }
    }
  }
  __syncthreads();  // the barriers' initialisation and the tails
  if (!live) return;
  const float *Gvx = sm + L.mat[0], *Gpy = sm + L.mat[1], *Gix = sm + L.mat[2];
  const float *Giy = sm + L.mat[3], *P = sm + L.mat[4], *Pd = sm + L.mat[5];
  const float *Pdd = sm + L.mat[6], *Al = sm + L.mat[7], *Kix = sm + L.mat[8];
  const float* Kiy = sm + L.mat[9];
  const float* arc = staged ? sm + L.arc : a.arc;
  const float* kap = staged ? sm + L.kap : a.kap;
  const float rho_i = a.rho_ineq, rho_p = a.rho_proj, rho_l = a.rho_lane;

  // ---- the guess QP ----
  // thread j < nvar: lincost_x[j] and c_bar_x[j]; thread 32 + j: the y side
  const bool xs = tid < nvar, ys = tid >= kWarp && tid < kWarp + nvar;
  const int j = xs ? tid : tid - kWarp;
  float cbar = 0.0f;
  mbar_wait(&bars[0]);
  if (xs) rx[j] = -chain_s<NSEG, NV>(prm, Gvx + j, nseg, nvar);
  if (ys) ry[j] = -chain_s<NSEG, NV>(prm, Gpy + j, nseg, nvar);
  if (tid >= 64 && tid < 67) rx[nvar + tid - 64] = beq;
  if (tid >= 96 && tid < 100) ry[nvar + tid - 96] = beq;
  row_sync(row);
  if (xs) cxb[j] = cbar = chain_s<NV ? NV + 3 : 0, 1>(rx, Gix + j * nx, nx, 1);
  if (ys) cyb[j] = cbar = chain_s<NV ? NV + 4 : 0, 1>(ry, Giy + j * ny, ny, 1);
  row_sync(row);

  // ---- the polar initialisation ----
  const int t = tid;
  const bool step = t < num;
  // the obstacle polar step of this step's position (px, py) in every
  // block: the radius into d buffer dout (clamped below by 1 for the
  // guess, by d_floor from buffer din else), the residuals into ro, their
  // block sums into rvo and, with_b, the b vectors' into bvo (each block
  // sum term o into accumulator o % 4, as PyTorch sums the blocks)
  auto obstacle_step = [&](float px, float py, int din, int dout, bool first, bool with_b) {
    if constexpr (OBS) {
      if (!step) return;
      const int bn = pad4(nblk * num);
      const float* dprev = rb_ + L.d + din * bn;
      float* dnew = rb_ + L.d + dout * bn;
      float sx[4] = {}, sy[4] = {}, bx[4] = {}, by[4] = {};
      for (int o = 0; o < nblk; ++o) {
        const int q = o * num + t;
        const float wc = sub(px, xo[q]), ws = sub(py, yo[q]);
        const float al = atan2f(mul(ws, a.a_obs), mul(wc, a.b_obs));
        const float c = cosf(al), s = sinf(al);
        const float c1 = mul(a.rho_obs, add(mul(a.a2_obs, mul(c, c)), mul(a.b2_obs, mul(s, s))));
        const float c2 =
            mul(a.rho_obs, add(mul(mul(a.a_obs, wc), c), mul(mul(a.b_obs, ws), s)));
        float d = __fdiv_rn(c2, c1);
        if (first) {
          d = clamp_min(d, 1.0f);
        } else {
          const float prev = t == 0 ? 1.0f : dprev[q - 1];
          d = mmd_order::maximum(d, add(1.0f, mul(a.g_obs, sub(prev, 1.0f))));
        }
        dnew[q] = d;
        const float res_x = sub(wc, mul(mul(a.a_obs, d), c));
        const float res_y = sub(ws, mul(mul(a.b_obs, d), s));
        ro[q] = res_x;
        ro[nblk * num + q] = res_y;
        sx[o & 3] = add(sx[o & 3], res_x);
        sy[o & 3] = add(sy[o & 3], res_y);
        if (with_b) {
          bx[o & 3] = add(bx[o & 3], add(xo[q], mul(mul(d, c), a.a_obs)));
          by[o & 3] = add(by[o & 3], add(yo[q], mul(mul(d, s), a.b_obs)));
        }
      }
      auto four = [](const float* v) { return add(add(add(v[0], v[1]), v[2]), v[3]); };
      rvo[t] = four(sx);
      rvo[L.numv + t] = four(sy);
      if (with_b) {
        bvo[t] = four(bx);
        bvo[L.numv + t] = four(by);
      }
    }
  };
  float xd = 0.0f, yd = 0.0f, xdd = 0.0f, ydd = 0.0f, xx = 0.0f, yy = 0.0f;
  mbar_wait(&bars[1]);
  if (step) {
    xd = chain_s<NV, 1>(cxb, Pd + t * nvar, nvar, 1);
    yd = chain_s<NV, 1>(cyb, Pd + t * nvar, nvar, 1);
    xdd = chain_s<NV, 1>(cxb, Pdd + t * nvar, nvar, 1);
    ydd = chain_s<NV, 1>(cyb, Pdd + t * nvar, nvar, 1);
  }
  float av = atan2f(yd, xd), aa = atan2f(ydd, xdd);
  {  // unwrap both angles along time: uw = av | aa | av's cum | aa's cum
    float *ua = uw, *ub = uw + numv, *ca = uw + 2 * numv, *cb = uw + 3 * numv;
    if (step) {
      ua[t] = av;
      ub[t] = aa;
    }
    row_sync(row);
    if (t < num - 1) {
      const float pa = unwrap_step(ua[t], ua[t + 1]), pb = unwrap_step(ub[t], ub[t + 1]);
      ca[t] = pa;
      cb[t] = pb;
      if (pa != 0.0f) flags[0] = 1.0f;
      if (pb != 0.0f) flags[1] = 1.0f;
    }
    row_sync(row);
    if (warp == 0 && flags[0] != 0.0f) aten_cumsum(ca, num - 1, a.scan_block, lane);
    if (warp == 1 && flags[1] != 0.0f) aten_cumsum(cb, num - 1, a.scan_block, lane);
    row_sync(row);
    if (t >= 1 && step) {
      av = add(av, ca[t - 1]);
      aa = add(aa, cb[t - 1]);
    }
  }
  float cav = cosf(av), sav = sinf(av), caa = cosf(aa), saa = sinf(aa);
  float dv = radius(xd, yd, cav, sav, rho_i, a.v_min, a.v_max);
  float da = radius(xdd, ydd, caa, saa, rho_i, 0.0f, a.a_max);
  // the residuals and the first round's b vectors
  auto polar_vectors = [&](bool with_b) {
    if (step) {
      const float bax = mul(da, caa), bay = mul(da, saa), bvx = mul(dv, cav),
                  bvy = mul(dv, sav);
      rv[t] = sub(xdd, bax);
      rv[numv + t] = sub(ydd, bay);
      rv[2 * numv + t] = sub(xd, bvx);
      rv[3 * numv + t] = sub(yd, bvy);
      if (with_b) {
        bv[t] = bax;
        bv[numv + t] = bay;
        bv[2 * numv + t] = bvx;
        bv[3 * numv + t] = bvy;
      }
    }
  };
  polar_vectors(true);
  if (lrow0 < nl) bl[lrow0] = sub(b_lane0, sl0);
  if (lrow1 < nl) bl[lrow1] = sub(b_lane1, sl1);
  if constexpr (OBS) {  // the guess's positions and their obstacle step
    float gx = 0.0f, gy = 0.0f;
    if (step) {
      gx = chain_s<NV, 1>(cxb, P + t * nvar, nvar, 1);
      gy = chain_s<NV, 1>(cyb, P + t * nvar, nvar, 1);
    }
    obstacle_step(gx, gy, 0, 0, true, true);
  }
  row_sync(row);

  // the pass's chains: slot o < 4 nvar the multipliers' (residual p = o /
  // nvar against Pdd or Pd), then 4 nvar right-hand sides' (b vector p);
  // from lane_base the lane chains (the residual, then b, against A_lane),
  // in a warp of their own where 8 nvar <= 96; in the obstacle-active form
  // then 4 nvar of the obstacle blocks' sums against P (residual x, y; b
  // x, y)
  const int lane_base = 8 * nvar <= 96 && 2 * nvar <= kWarp ? 96 : 8 * nvar;
  const int obs_base = lane_base + 2 * nvar;
  const int slots = obs_base + (OBS ? 4 * nvar : 0);
  float rn = 0.0f, cxy = 0.0f;
  for (int it = 0; it <= a.maxiter; ++it) {
    const bool m_lane = it > 0, with_b = it < a.maxiter;
    // ---- a pass: multipliers and right-hand sides ----
    for (int o = tid; o < slots; o += kRowThreads) {
      if (o < 8 * nvar) {
        const int b = o >= 4 * nvar, p = (o - b * 4 * nvar) / nvar, jj = o % nvar;
        if (b && !with_b) continue;
        const float* v = (b ? bv : rv) + p * numv;
        const float v0 = chain<NUM, NV>(v, (p < 2 ? Pdd : Pd) + jj, num, nvar);
        (b ? bres : mres)[p * kCo + jj] = v0;
      } else if (o >= lane_base && o < obs_base) {
        const int b = o - lane_base >= nvar, jj = (o - lane_base) % nvar;
        if (b ? !with_b : !m_lane) continue;
        const float v0 = chain<NL, NV>(b ? bl : rl, Al + jj, nl, nvar);
        (b ? bres : mres)[4 * kCo + jj] = v0;
      } else if (OBS && o >= obs_base) {
        const int p = (o - obs_base) / nvar, jj = (o - obs_base) % nvar;
        if (p >= 2 && !with_b) continue;
        const float* v = (p < 2 ? rvo : bvo) + (p & 1) * numv;
        ores[p * kCo + jj] = chain<NUM, NV>(v, P + jj, num, nvar);
      }
    }
    row_sync(row);
    if (xs) {
      lxy = sub(sub(lxy, mul(rho_i, mres[0 * kCo + j])), mul(rho_i, mres[2 * kCo + j]));
      if (OBS) lxy = sub(lxy, mul(a.rho_obs, ores[j]));
      if (with_b) {
        float lcx = sub(sub(sub(-lxy, mul(rho_p, cbar)), mul(rho_i, bres[0 * kCo + j])),
                        mul(rho_i, bres[2 * kCo + j]));
        if (OBS) lcx = sub(lcx, mul(a.rho_obs, ores[2 * kCo + j]));
        rx[j] = -lcx;
      }
    }
    if (ys) {
      float l = sub(sub(lxy, mul(rho_i, mres[1 * kCo + j])), mul(rho_i, mres[3 * kCo + j]));
      if (m_lane) l = sub(l, mul(rho_l, mres[4 * kCo + j]));
      if (OBS) l = sub(l, mul(a.rho_obs, ores[kCo + j]));
      lxy = l;
      if (with_b) {
        float lcy =
            sub(sub(sub(sub(-lxy, mul(rho_p, cbar)), mul(rho_i, bres[1 * kCo + j])),
                    mul(rho_i, bres[3 * kCo + j])),
                mul(rho_l, bres[4 * kCo + j]));
        if (OBS) lcy = sub(lcy, mul(a.rho_obs, ores[3 * kCo + j]));
        ry[j] = -lcy;
      }
    }
    if (it > 0 && tid == 0) {
      rn = add(add(nrm[0], nrm[1]), nrm[2]);
      if (OBS) rn = add(rn, nrm[3]);
    }
    if (!with_b) break;
    row_sync(row);

    // ---- the KKT solves ----
    if (xs) cx[j] = cxy = chain_s<NV ? NV + 3 : 0, 1>(rx, Kix + j * nx, nx, 1);
    if (ys) cy[j] = cxy = chain_s<NV ? NV + 4 : 0, 1>(ry, Kiy + j * ny, ny, 1);
    row_sync(row);

    // ---- the trajectory and the lane rows ----
    // from the coefficients c_x, c_y (at the compile-time shape a copy in
    // registers)
    auto trajectory = [&](const float* px, const float* py) {
      if (step) {
        xx = chain_s<NV, 1>(px, P + t * nvar, nvar, 1);
        yy = chain_s<NV, 1>(py, P + t * nvar, nvar, 1);
        xd = chain_s<NV, 1>(px, Pd + t * nvar, nvar, 1);
        yd = chain_s<NV, 1>(py, Pd + t * nvar, nvar, 1);
        xdd = chain_s<NV, 1>(px, Pdd + t * nvar, nvar, 1);
        ydd = chain_s<NV, 1>(py, Pdd + t * nvar, nvar, 1);
      }
      if (lrow0 < nl) {
        const float lv = chain_s<NV, 1>(py, Al + lrow0 * nvar, nvar, 1);
        sl0 = clamp_min(add(-lv, b_lane0), 0.0f);
        rl[lrow0] = add(sub(lv, b_lane0), sl0);
      }
      if (lrow1 < nl) {
        const float lv = chain_s<NV, 1>(py, Al + lrow1 * nvar, nvar, 1);
        sl1 = clamp_min(add(-lv, b_lane1), 0.0f);
        rl[lrow1] = add(sub(lv, b_lane1), sl1);
      }
    };
    if constexpr (NV > 0) {
      float cxr[NV], cyr[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        cxr[k] = cx[k];
        cyr[k] = cy[k];
      }
      trajectory(cxr, cyr);
    } else {
      trajectory(cx, cy);
    }

    // ---- the polar re-estimate ----
    av = atan2f(yd, xd);
    aa = atan2f(ydd, xdd);
    cav = cosf(av);
    sav = sinf(av);
    caa = cosf(aa);
    saa = sinf(aa);
    dv = radius(xd, yd, cav, sav, rho_i, a.v_min, a.v_max);
    da = radius(xdd, ydd, caa, saa, rho_i, 0.0f, a.a_max);
    const bool next = it + 1 < a.maxiter;
    polar_vectors(next);
    if (next) {
      if (lrow0 < nl) bl[lrow0] = sub(b_lane0, sl0);
      if (lrow1 < nl) bl[lrow1] = sub(b_lane1, sl1);
    }
    obstacle_step(xx, yy, it & 1, (it + 1) & 1, false, next);
    row_sync(row);

    // ---- the norms ----
    // one warp each, in the order of the plain chain's (rows, 2 num) and
    // (rows, 2 (num - 1)) tensors
    if (warp < 3) {
      const int len = warp < 2 ? 2 * num : nl;
      const int shift = static_cast<int>((static_cast<long long>(r) * len) % 4);
      const float* base = warp == 0 ? rv : warp == 1 ? rv + 2 * numv : rl;
      const int second = warp < 2 ? numv : 0;  // the second vector of a pair
      const float s = mmd_order::row_reduce(
          [&](int i) { return warp < 2 && i >= num ? base[second + i - num] : base[i]; }, len,
          shift, Square(), lane);
      if (lane == 0) nrm[warp] = sqrtf(s);
    } else if (OBS) {  // the obstacle residuals' norm, (rows, 2 nblk num)
      const int len = 2 * nblk * num;
      const int shift = static_cast<int>((static_cast<long long>(r) * len) % 4);
      const float s = mmd_order::row_reduce([&](int i) { return ro[i]; }, len, shift,
                                            Square(), lane);
      if (lane == 0) nrm[3] = sqrtf(s);
    }
  }

  // ---- the path, the controls, the outputs ----
  const size_t rbase = static_cast<size_t>(r) * num;
  float* spd = bv;  // the speed, for the forward difference
  if (step) spd[t] = sqrtf(add(mul(xd, xd), mul(yd, yd)));
  row_sync(row);
  if (step) {
    float ki = 0.0f, st = 0.0f;
    if (npath > 0) {
      const float xon = minimum(clamp_min(xx, 0.0f), arc[npath - 1]);
      ki = interp(xon, arc, kap, npath);
      const float kf = __fdiv_rn(mul(da, sinf(sub(aa, av))), mul(dv, dv));
      st = atanf(mul(add(kf, __fdiv_rn(mul(ki, cav), sub(1.0f, mul(yy, ki)))), a.wheel_base));
    }
    const float v = spd[t], vn = t + 1 < num ? spd[t + 1] : v;
    const float sq = add(mul(xd, xd), mul(yd, yd));
    const float curv = __fdiv_rn(sub(mul(ydd, xd), mul(yd, xdd)), powf(sq, 1.5f));
    a.x[rbase + t] = xx;
    a.y[rbase + t] = yy;
    a.xdot[rbase + t] = xd;
    a.ydot[rbase + t] = yd;
    a.xddot[rbase + t] = xdd;
    a.yddot[rbase + t] = ydd;
    a.steering[rbase + t] = st;
    a.kappa_interp[rbase + t] = ki;
    a.acc[rbase + t] = mul(sub(vn, v), a.inv_dt);
    a.steer[rbase + t] = atanf(mul(curv, a.wheel_base));
  }
  if (lrow0 < nl) a.s_lane[static_cast<size_t>(r) * nl + lrow0] = sl0;
  if (lrow1 < nl) a.s_lane[static_cast<size_t>(r) * nl + lrow1] = sl1;
  if (xs) {
    a.c_x[r * nvar + j] = cxy;
    a.lamda_x[r * nvar + j] = lxy;
  }
  if (ys) {
    a.c_y[r * nvar + j] = cxy;
    a.lamda_y[r * nvar + j] = lxy;
  }
  if (tid == 0) a.res_norm[r] = rn;
  // ---- the end of the row ----
}

template <int NV, int NUM, int NSEG, int ROWS, bool OBS>
int launch(const Args& a, int bytes, cudaStream_t stream) {
  static const cudaError_t opted =
      cudaFuncSetAttribute(outer_project_kernel<NV, NUM, NSEG, ROWS, OBS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int blocks = (a.rows + ROWS - 1) / ROWS;
  outer_project_kernel<NV, NUM, NSEG, ROWS, OBS>
      <<<blocks, ROWS * kRowThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool OBS>
int launch_form(const Args& a, int bytes, cudaStream_t s, int rows_per_cta, int compiled) {
  if (compiled)
    return rows_per_cta == 1 ? launch<kNvar, kNum, kSeg, 1, OBS>(a, bytes, s)
                             : launch<kNvar, kNum, kSeg, 2, OBS>(a, bytes, s);
  return rows_per_cta == 1 ? launch<0, 0, 0, 1, OBS>(a, bytes, s)
                           : launch<0, 0, 0, 2, OBS>(a, bytes, s);
}

}  // namespace

// Inputs: params (rows, 2 nseg), b_eq_x (rows, 3), b_eq_y (rows, 4),
// lamda_x, lamda_y (rows, nvar), s_lane (rows, 2 (num - 1)); the
// workspace's G_vx, G_py (nseg, nvar), guess KKT inverses (nvar + 3)^2 and
// (nvar + 4)^2, P, Pdot, Pddot (num, nvar), A_lane (2 (num - 1), nvar),
// projection KKT inverses; arc, kappa (npath) or null with npath 0.
// Outputs as ops/outer_project.OuterProjection.  The constants as
// ops/outer_project.constants gives them.  rows_per_cta 1 or 2 rows a CTA;
// compiled 1 for the compile-time instantiation (nvar 11, num 100, 4
// segments: refused at another shape), 0 for the run-time one
// (ops/outer_project.launch_choice picks both).  x_obs, y_obs null and
// nblk 0 for the stochastic form; else the obstacles (rows / per_scen,
// nblk, num) of the obstacle-active form, its constants as
// ops/outer_project.obstacle_constants gives them.
extern "C" int mmd_outer_project(
    const float* params, const float* b_eq_x, const float* b_eq_y, const float* lamda_x0,
    const float* lamda_y0, const float* s_lane0, const float* G_vx, const float* G_py,
    const float* Gix, const float* Giy, const float* P, const float* Pd, const float* Pdd,
    const float* Al, const float* Kix, const float* Kiy, const float* arc, const float* kap,
    float* c_x, float* c_y, float* x, float* y, float* xdot, float* ydot, float* xddot,
    float* yddot, float* res_norm, float* lamda_x, float* lamda_y, float* s_lane,
    float* steering, float* kappa_interp, float* acc, float* steer, int rows, int nvar, int num,
    int nseg, int maxiter, int npath, float rho_ineq, float rho_proj, float rho_lane,
    float lane_ub, float lane_lb, float v_min, float v_max, float a_max, float inv_dt,
    float wheel_base, int rows_per_cta, int compiled, const float* x_obs, const float* y_obs,
    int nblk, int per_scen, float rho_obs, float a_obs, float b_obs, float a2_obs,
    float b2_obs, float g_obs, void* stream) {
  if (rows <= 0) return 0;
  if (nvar < 1 || nvar > kMaxNvar || num < 2 || num > kMaxNum || nseg < 1 || nseg > kMaxSeg ||
      maxiter < 1 || (npath > 0 && (arc == nullptr || kap == nullptr)) ||
      (rows_per_cta != 1 && rows_per_cta != 2) ||
      (compiled && (nvar != kNvar || num != kNum || nseg != kSeg)) || nblk < 0 ||
      (nblk > 0 && (x_obs == nullptr || y_obs == nullptr || per_scen < 1 ||
                    rows % per_scen != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  int staged = npath > 0 && npath <= kMaxPathStaged ? npath : 0;
  int bytes = smem_layout(nvar, num, nseg, staged, rows_per_cta, nblk).total * 4;
  if (bytes > kMaxSmem) {  // the path from device memory
    staged = 0;
    bytes = smem_layout(nvar, num, nseg, 0, rows_per_cta, nblk).total * 4;
  }
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{params, b_eq_x, b_eq_y, lamda_x0, lamda_y0, s_lane0, G_vx, G_py, Gix, Giy, P,
               Pd, Pdd, Al, Kix, Kiy, arc, kap, c_x, c_y, x, y, xdot, ydot, xddot, yddot,
               res_norm, lamda_x, lamda_y, s_lane, steering, kappa_interp, acc, steer, rows,
               nvar, num, nseg, maxiter, npath, staged > 0,
               mmd_order::cumsum_block(static_cast<unsigned>(rows), static_cast<unsigned>(num - 1)),
               rho_ineq, rho_proj, rho_lane,
               lane_ub, lane_lb, v_min, v_max, a_max, inv_dt, wheel_base, x_obs, y_obs, nblk,
               per_scen, rho_obs, a_obs, b_obs, a2_obs, b2_obs, g_obs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nblk > 0 ? launch_form<true>(a, bytes, s, rows_per_cta, compiled)
                  : launch_form<false>(a, bytes, s, rows_per_cta, compiled);
}
