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
// and fmodf as PyTorch's kernels call them (no fast-math); a tensor over a
// Python float as a product with the float32 reciprocal.  The one sum
// whose order is not PyTorch's is unwrap's cumulative sum of the 2 pi
// corrections, taken left to right: it gives PyTorch's bits wherever a
// row's partial sums of corrections are exact (fewer than three
// corrections, or alternating ones), since every order then rounds the
// same exact value once.
//
// What bounds it on the card: per launch it reads the rows' inputs and
// about 26 KB of shared matrices and writes 13 rows of num floats a row
// (0.34 MB at fastrt's 64 rows): 0.1 us of memory.  Its work is about 25
// products of 100 x 11 a row and round 10 transcendental calls a step:
// 2e7 float operations at 64 rows, 0.3 us.  What bounds it instead is the
// latency of a row's chain of dependent phases (guess, polar step, the AM
// round's two KKT products, the norms, the multiplier chains of 100 and
// 198 fused multiply-adds a coefficient), which one warp runs with four
// rows to a block of 128 threads; the rows' matrices are staged in shared
// memory once a block.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

namespace {

using mmd_order::clamp;
using mmd_order::clamp_min;
using mmd_order::kFull;
using mmd_order::minimum;
using mmd_order::Square;

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;  // a warp a row
constexpr int kSlots = 4;         // time steps a lane: num <= 128
constexpr int kLaneSlots = 8;     // lane rows a lane: 2 (num - 1) <= 254
constexpr int kMaxNvar = 16;
constexpr int kMaxSeg = 8;
constexpr int kCo = kMaxNvar + 4;  // a coefficient buffer (a KKT right-hand side)
constexpr int kMaxSmem = 232448;
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
  int rows, nvar, num, nseg, maxiter, npath;
  float rho_ineq, rho_proj, rho_lane, lane_ub, lane_lb, v_min, v_max, a_max, inv_dt,
      wheel_base;
};

// shared floats: the matrices, then per warp 4 num (a contraction's
// vectors, the cat of two residuals in one run), a lane vector and the
// coefficient buffers
struct Smem {
  int gvx, gpy, gix, giy, p, pd, pdd, al, kix, kiy, mats, per_warp, total;
};

__host__ __device__ inline Smem smem_layout(int nvar, int num, int nseg) {
  Smem s{};
  const int nl = 2 * (num - 1), nx = nvar + 3, ny = nvar + 4;
  int o = 0;
  s.gvx = o; o += nseg * nvar;
  s.gpy = o; o += nseg * nvar;
  s.gix = o; o += nx * nx;
  s.giy = o; o += ny * ny;
  s.p = o; o += num * nvar;
  s.pd = o; o += num * nvar;
  s.pdd = o; o += num * nvar;
  s.al = o; o += nl * nvar;
  s.kix = o; o += nx * nx;
  s.kiy = o; o += ny * ny;
  s.mats = o;
  s.per_warp = 4 * num + nl + 13 * kCo;
  s.total = o + kRowsPerBlock * s.per_warp;
  return s;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// One output of a product as cuBLAS's FFMA kernels take it: sum_k c[k]
// m[k stride] as fused multiply-adds from 0, k ascending.
__device__ __forceinline__ float dot(const float* c, const float* m, int K, int stride) {
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc = __fmaf_rn(c[k], m[k * stride], acc);
  return acc;
}

// c @ W.T of one output: W (nout, K) row-major, its row o
__device__ __forceinline__ float dot_t(const float* c, const float* m, int K) {
  return dot(c, m, K, 1);
}

// v @ M of one output j of nout: M (K, nout) row-major
__device__ __forceinline__ float dot_s(const float* v, const float* M, int K, int nout, int j) {
  return dot(v, M + j, K, nout);
}

// torch.remainder of a by b > 0 on the card
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = add(m, b);
  return m;
}

// The polar step of (wx, wy) at alpha: the clipped radius
__device__ __forceinline__ float radius(float wx, float wy, float alpha, float rho, float lo,
                                        float hi) {
  const float c = cosf(alpha), s = sinf(alpha);
  const float c1 = mul(rho, add(mul(c, c), mul(s, s)));
  const float c2 = mul(rho, add(mul(wx, c), mul(wy, s)));
  return clamp(__fdiv_rn(c2, c1), lo, hi);
}

// unwrap along time of the warp's angles a[s] (step lane + 32 s), in place;
// buf: num floats of the warp's shared memory
__device__ __forceinline__ void unwrap(float (&a)[kSlots], int num, int lane, float* buf, float* cum) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    if (t < num) buf[t] = a[s];
  }
  __syncwarp();
  bool any = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    if (t < num - 1) {
      const float dd = sub(buf[t + 1], buf[t]);
      float ddmod = sub(remainder(add(dd, kInterval), kPeriod), kInterval);
      if (ddmod == -kInterval && dd > 0.0f) ddmod = kInterval;
      const float ph = fabsf(dd) < kInterval ? 0.0f : sub(ddmod, dd);
      cum[t] = ph;
      any = any || ph != 0.0f;
    }
  }
  __syncwarp();
  if (__any_sync(kFull, any)) {
    if (lane == 0) {
      float run = 0.0f;
      for (int t = 0; t < num - 1; ++t) {
        run = add(run, cum[t]);
        cum[t] = run;
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    if (t >= 1 && t < num) a[s] = add(a[s], cum[t - 1]);
  }
  __syncwarp();
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

__global__ void __launch_bounds__(kRowsPerBlock* kWarp)
    outer_project_kernel(const Args a) {
  extern __shared__ float sm[];
  const int nvar = a.nvar, num = a.num, nseg = a.nseg, nl = 2 * (num - 1);
  const int nx = nvar + 3, ny = nvar + 4;
  const Smem L = smem_layout(nvar, num, nseg);
  {  // stage the shared matrices
    const float* src[10] = {a.G_vx, a.G_py, a.Gix, a.Giy, a.P, a.Pd, a.Pdd, a.Al, a.Kix, a.Kiy};
    const int off[10] = {L.gvx, L.gpy, L.gix, L.giy, L.p, L.pd, L.pdd, L.al, L.kix, L.kiy};
    const int n[10] = {nseg * nvar, nseg * nvar, nx * nx, ny * ny, num * nvar, num * nvar,
                       num * nvar, nl * nvar, nx * nx, ny * ny};
    for (int m = 0; m < 10; ++m)
      for (int i = threadIdx.x; i < n[m]; i += blockDim.x) sm[off[m] + i] = src[m][i];
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int r = blockIdx.x * kRowsPerBlock + warp;
  if (r >= a.rows) return;

  const float *Gvx = sm + L.gvx, *Gpy = sm + L.gpy, *Gix = sm + L.gix, *Giy = sm + L.giy;
  const float *P = sm + L.p, *Pd = sm + L.pd, *Pdd = sm + L.pdd, *Al = sm + L.al;
  const float *Kix = sm + L.kix, *Kiy = sm + L.kiy;
  float* wb = sm + L.mats + warp * L.per_warp;
  float* vb = wb;               // 4 num: ax | ay | vx | vy (or b_ax | b_ay | b_vx | b_vy)
  float* lb = vb + 4 * num;     // nl: the lane vector of a contraction
  float* co = lb + nl;          // 13 coefficient buffers of kCo
  float *cxb = co, *cyb = co + kCo, *lx = co + 2 * kCo, *ly = co + 3 * kCo;
  float *cx = co + 4 * kCo, *cy = co + 5 * kCo, *rx = co + 6 * kCo, *ry = co + 7 * kCo;
  float* tmp = co + 8 * kCo;    // 5 x kCo: contraction results
  const float rho_i = a.rho_ineq, rho_p = a.rho_proj, rho_l = a.rho_lane;

  // ---- the guess QP ----
  {
    const float* prm = a.params + static_cast<size_t>(r) * 2 * nseg;
    if (lane < nvar) {
      const int j = lane;
      const float lcx = dot_s(prm, Gvx, nseg, nvar, j);
      const float lcy = dot_s(prm + nseg, Gpy, nseg, nvar, j);
      rx[j] = -lcx;
      ry[j] = -lcy;
    }
    if (lane < 3) rx[nvar + lane] = a.b_eq_x[r * 3 + lane];
    if (lane < 4) ry[nvar + lane] = a.b_eq_y[r * 4 + lane];
    __syncwarp();
    if (lane < nvar) cxb[lane] = dot_t(rx, Gix + lane * nx, nx);
    else if (lane >= 16 && lane < 16 + nvar) cyb[lane - 16] = dot_t(ry, Giy + (lane - 16) * ny, ny);
    if (lane < nvar) {
      lx[lane] = a.lamda_x0[r * nvar + lane];
      ly[lane] = a.lamda_y0[r * nvar + lane];
    }
    __syncwarp();
  }

  // ---- the polar initialisation ----
  float xd[kSlots], yd[kSlots], xdd[kSlots], ydd[kSlots], xx[kSlots], yy[kSlots];
  float av[kSlots], dv[kSlots], aa[kSlots], da[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    xd[s] = yd[s] = xdd[s] = ydd[s] = xx[s] = yy[s] = 0.0f;
    if (t < num) {
      xd[s] = dot_t(cxb, Pd + t * nvar, nvar);
      yd[s] = dot_t(cyb, Pd + t * nvar, nvar);
      xdd[s] = dot_t(cxb, Pdd + t * nvar, nvar);
      ydd[s] = dot_t(cyb, Pdd + t * nvar, nvar);
    }
    av[s] = atan2f(yd[s], xd[s]);
    aa[s] = atan2f(ydd[s], xdd[s]);
  }
  unwrap(av, num, lane, vb, vb + num);
  unwrap(aa, num, lane, vb, vb + num);

  // residuals into vb (ax | ay | vx | vy) from the polar estimate
  auto residuals = [&]() {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int t = lane + s * kWarp;
      if (t < num) {
        vb[t] = sub(xdd[s], mul(da[s], cosf(aa[s])));
        vb[num + t] = sub(ydd[s], mul(da[s], sinf(aa[s])));
        vb[2 * num + t] = sub(xd[s], mul(dv[s], cosf(av[s])));
        vb[3 * num + t] = sub(yd[s], mul(dv[s], sinf(av[s])));
      }
    }
    __syncwarp();
  };
  // the multiplier step: lamda_x -= rho_i (ax @ Pdd) + rho_i (vx @ Pd),
  // lamda_y -= rho_i (ay @ Pdd) + rho_i (vy @ Pd) [+ rho_l (lane @ Al)]
  auto multipliers = [&](bool with_lane) {
    for (int idx = lane; idx < 5 * nvar; idx += kWarp) {
      const int p = idx / nvar, j = idx % nvar;
      float v;
      if (p == 4) {
        if (!with_lane) continue;
        v = dot_s(lb, Al, nl, nvar, j);
      } else {
        v = dot_s(vb + p * num, p < 2 ? Pdd : Pd, num, nvar, j);
      }
      tmp[p * kCo + j] = v;
    }
    __syncwarp();
    if (lane < nvar) {
      const int j = lane;
      lx[j] = sub(sub(lx[j], mul(rho_i, tmp[0 * kCo + j])), mul(rho_i, tmp[2 * kCo + j]));
      float l = sub(sub(ly[j], mul(rho_i, tmp[1 * kCo + j])), mul(rho_i, tmp[3 * kCo + j]));
      if (with_lane) l = sub(l, mul(rho_l, tmp[4 * kCo + j]));
      ly[j] = l;
    }
    __syncwarp();
  };

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    dv[s] = radius(xd[s], yd[s], av[s], rho_i, a.v_min, a.v_max);
    da[s] = radius(xdd[s], ydd[s], aa[s], rho_i, 0.0f, a.a_max);
  }
  residuals();
  multipliers(false);

  float sl[kLaneSlots], lv[kLaneSlots];
#pragma unroll
  for (int s = 0; s < kLaneSlots; ++s) {
    const int l = lane + s * kWarp;
    sl[s] = l < nl ? a.s_lane0[static_cast<size_t>(r) * nl + l] : 0.0f;
  }
  auto b_lane = [&](int l) { return l < num - 1 ? a.lane_ub : a.lane_lb; };

  float rn = 0.0f;
  for (int it = 0; it < a.maxiter; ++it) {
    // the right-hand sides: b vectors into vb and lb, then the lincosts
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int t = lane + s * kWarp;
      if (t < num) {
        vb[t] = mul(da[s], cosf(aa[s]));
        vb[num + t] = mul(da[s], sinf(aa[s]));
        vb[2 * num + t] = mul(dv[s], cosf(av[s]));
        vb[3 * num + t] = mul(dv[s], sinf(av[s]));
      }
    }
#pragma unroll
    for (int s = 0; s < kLaneSlots; ++s) {
      const int l = lane + s * kWarp;
      if (l < nl) lb[l] = sub(b_lane(l), sl[s]);
    }
    __syncwarp();
    for (int idx = lane; idx < 5 * nvar; idx += kWarp) {
      const int p = idx / nvar, j = idx % nvar;
      tmp[p * kCo + j] = p == 4 ? dot_s(lb, Al, nl, nvar, j)
                                : dot_s(vb + p * num, p < 2 ? Pdd : Pd, num, nvar, j);
    }
    __syncwarp();
    if (lane < nvar) {
      const int j = lane;
      const float lcx = sub(sub(sub(-lx[j], mul(rho_p, cxb[j])), mul(rho_i, tmp[0 * kCo + j])),
                            mul(rho_i, tmp[2 * kCo + j]));
      const float lcy =
          sub(sub(sub(sub(-ly[j], mul(rho_p, cyb[j])), mul(rho_i, tmp[1 * kCo + j])),
                  mul(rho_i, tmp[3 * kCo + j])),
              mul(rho_l, tmp[4 * kCo + j]));
      rx[j] = -lcx;
      ry[j] = -lcy;
    }
    // rx, ry keep b_eq from the guess past nvar
    __syncwarp();
    if (lane < nvar) cx[lane] = dot_t(rx, Kix + lane * nx, nx);
    else if (lane >= 16 && lane < 16 + nvar) cy[lane - 16] = dot_t(ry, Kiy + (lane - 16) * ny, ny);
    __syncwarp();

    // the trajectory and its derivatives
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int t = lane + s * kWarp;
      if (t < num) {
        xx[s] = dot_t(cx, P + t * nvar, nvar);
        yy[s] = dot_t(cy, P + t * nvar, nvar);
        xd[s] = dot_t(cx, Pd + t * nvar, nvar);
        yd[s] = dot_t(cy, Pd + t * nvar, nvar);
        xdd[s] = dot_t(cx, Pdd + t * nvar, nvar);
        ydd[s] = dot_t(cy, Pdd + t * nvar, nvar);
      }
    }
    // the lane rows: slack and residual
#pragma unroll
    for (int s = 0; s < kLaneSlots; ++s) {
      const int l = lane + s * kWarp;
      if (l < nl) {
        lv[s] = dot_t(cy, Al + l * nvar, nvar);
        sl[s] = clamp_min(add(-lv[s], b_lane(l)), 0.0f);
        lb[l] = add(sub(lv[s], b_lane(l)), sl[s]);
      }
    }
    // the polar re-estimate
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      av[s] = atan2f(yd[s], xd[s]);
      aa[s] = atan2f(ydd[s], xdd[s]);
      dv[s] = radius(xd[s], yd[s], av[s], rho_i, a.v_min, a.v_max);
      da[s] = radius(xdd[s], ydd[s], aa[s], rho_i, 0.0f, a.a_max);
    }
    residuals();  // also orders lb's writes before the reads below
    const int shift_a = static_cast<int>((static_cast<long long>(r) * 2 * num) % 4);
    const int shift_l = static_cast<int>((static_cast<long long>(r) * nl) % 4);
    const float n_a = sqrtf(mmd_order::row_reduce([&](int i) { return vb[i]; }, 2 * num,
                                                  shift_a, Square(), lane));
    const float n_v = sqrtf(mmd_order::row_reduce([&](int i) { return vb[2 * num + i]; },
                                                  2 * num, shift_a, Square(), lane));
    const float n_l =
        sqrtf(mmd_order::row_reduce([&](int i) { return lb[i]; }, nl, shift_l, Square(), lane));
    rn = add(add(n_a, n_v), n_l);
    multipliers(true);
  }

  // ---- the path, the controls, the outputs ----
  const size_t rb = static_cast<size_t>(r) * num;
  float* vbuf = vb;  // the speed, for the forward difference
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    if (t < num) vbuf[t] = sqrtf(add(mul(xd[s], xd[s]), mul(yd[s], yd[s])));
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int t = lane + s * kWarp;
    if (t >= num) continue;
    float ki = 0.0f, st = 0.0f;
    if (a.npath > 0) {
      const float xon = minimum(clamp_min(xx[s], 0.0f), a.arc[a.npath - 1]);
      ki = interp(xon, a.arc, a.kap, a.npath);
      const float kf = __fdiv_rn(mul(da[s], sinf(sub(aa[s], av[s]))), mul(dv[s], dv[s]));
      st = atanf(mul(add(kf, __fdiv_rn(mul(ki, cosf(av[s])), sub(1.0f, mul(yy[s], ki)))),
                     a.wheel_base));
    }
    const float v = vbuf[t], vn = t + 1 < num ? vbuf[t + 1] : v;
    const float sq = add(mul(xd[s], xd[s]), mul(yd[s], yd[s]));
    const float curv = __fdiv_rn(sub(mul(ydd[s], xd[s]), mul(yd[s], xdd[s])), powf(sq, 1.5f));
    a.x[rb + t] = xx[s];
    a.y[rb + t] = yy[s];
    a.xdot[rb + t] = xd[s];
    a.ydot[rb + t] = yd[s];
    a.xddot[rb + t] = xdd[s];
    a.yddot[rb + t] = ydd[s];
    a.steering[rb + t] = st;
    a.kappa_interp[rb + t] = ki;
    a.acc[rb + t] = mul(sub(vn, v), a.inv_dt);
    a.steer[rb + t] = atanf(mul(curv, a.wheel_base));
  }
#pragma unroll
  for (int s = 0; s < kLaneSlots; ++s) {
    const int l = lane + s * kWarp;
    if (l < nl) a.s_lane[static_cast<size_t>(r) * nl + l] = sl[s];
  }
  if (lane < nvar) {
    a.c_x[r * nvar + lane] = cx[lane];
    a.c_y[r * nvar + lane] = cy[lane];
    a.lamda_x[r * nvar + lane] = lx[lane];
    a.lamda_y[r * nvar + lane] = ly[lane];
  }
  if (lane == 0) a.res_norm[r] = rn;
}

}  // namespace

// Inputs: params (rows, 2 nseg), b_eq_x (rows, 3), b_eq_y (rows, 4),
// lamda_x, lamda_y (rows, nvar), s_lane (rows, 2 (num - 1)); the
// workspace's G_vx, G_py (nseg, nvar), guess KKT inverses (nvar + 3)^2 and
// (nvar + 4)^2, P, Pdot, Pddot (num, nvar), A_lane (2 (num - 1), nvar),
// projection KKT inverses; arc, kappa (npath) or null with npath 0.
// Outputs as ops/outer_project.OuterProjection.  The constants as
// ops/outer_project.constants gives them.
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
    float wheel_base, void* stream) {
  if (rows <= 0) return 0;
  if (nvar < 1 || nvar > kMaxNvar || num < 2 || num > kSlots * kWarp || nseg < 1 ||
      nseg > kMaxSeg || maxiter < 1 || (npath > 0 && (arc == nullptr || kap == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{params, b_eq_x, b_eq_y, lamda_x0, lamda_y0, s_lane0, G_vx, G_py, Gix, Giy, P,
               Pd, Pdd, Al, Kix, Kiy, arc, kap, c_x, c_y, x, y, xdot, ydot, xddot, yddot,
               res_norm, lamda_x, lamda_y, s_lane, steering, kappa_interp, acc, steer, rows,
               nvar, num, nseg, maxiter, npath, rho_ineq, rho_proj, rho_lane, lane_ub, lane_lb,
               v_min, v_max, a_max, inv_dt, wheel_base};
  const int bytes = smem_layout(nvar, num, nseg).total * static_cast<int>(sizeof(float));
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t opted = cudaFuncSetAttribute(
      outer_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return static_cast<int>(opted);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  outer_project_kernel<<<blocks, kRowsPerBlock * kWarp, bytes,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
