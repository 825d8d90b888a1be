// Kernel (e): an outer CEM iteration's step from the reduced sets to the
// next parameters, for every scenario of a chunk in one launch.
//
// Replaces what XLA fuses from the JAX package's outer iteration in
// mmd_opt (mpc_mmd_tpu/solver.py:235-300, solver_frenet.py:201-257: the
// obstacle risk, the sort by risk, the lane risks, the scalar cost, the
// sort by cost, cem_update at sampling.py:74, the best candidate), which
// the port ran as about 150 PyTorch launches an outer iteration plus the
// sorts and gathers (ops/outer_tail.py's plain version: risk.mmd_obs,
// sampling.cem_tail).  Like kernels (a)-(d) it replaces an XLA lowering.
//
// Per scenario n of N, with the candidates in the order of the
// projection residual (position i is projection row n nb + order[n, i]):
//   1. the obstacle risk of every candidate: the violation of each reduced
//      rollout (the largest of clamp(1 - dx^2 / a^2 - dy^2 / b^2, 0) over
//      the obstacles and the steps) and its MMD against zero with the
//      candidate's beta and sigma;
//   2. the n_cost least risks, by a stable sort (NaN last, ties by index);
//   3. their lane risk (the MMD of the lower and upper lane violations)
//      and, on the road where weight_lane_des is not 0, the weighted
//      desired-lane risk;
//   4. their scalar cost (sampling.scalar_cost, or frenet_scalar_cost);
//   5. the n_el least costs, by a stable sort;
//   6. cem_update: the exponential weights, the mean and covariance
//      moving averages with the jitter, the Cholesky factor (as cuSOLVER's
//      batched potrf, which cholesky_ex runs on the card, computes it: the
//      subtractions as fused multiply-adds in column order, the column
//      scaled by the IEEE reciprocal of the pivot's square root; all NaN
//      where a pivot is not positive) and the resample mean + z L^T with
//      the velocities clipped;
//   7. res[n, it] the least elite cost, res_2[n, it] the residual of the
//      reference's pick (the first kept candidate, or the first NaN
//      elite's slot), and that candidate's position, risk and lane risk;
//      the kept candidates' positions and the elites' indices among them.
//
// The arithmetic follows the plain chain on the card operation for
// operation (torch_order.cuh: each sum in PyTorch's order; each
// elementwise step with its own rounding; expf, sqrtf as PyTorch's
// kernels call them; a tensor over a Python float as a product with the
// float32 reciprocal), so that the kernel gives its bits.
//
// What bounds it on the card: per scenario it reads the reduced rollouts
// (nb R T floats twice: 0.26 MB at fastrt) and the candidates' rows,
// and evaluates nb R num_obs T violations (3.2e5 at fastrt) and nb R^2
// kernel values: microseconds of either over the card, but the steps
// after the risk are a chain of small dependent phases.  A scenario is a
// thread-block cluster of cs CTAs (1, 2, 4 or 8; the wrapper picks the
// size, utils/kernel_ab.py times them): each CTA scores its share of the
// candidates' risks (phase 1), rank 0 reads the others' risks through
// distributed shared memory and runs phases 2-7 alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

namespace cg = cooperative_groups;

namespace {

using mmd_order::Add;
using mmd_order::clamp;
using mmd_order::clamp_min;
using mmd_order::kFull;
using mmd_order::Square;

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxNb = 256;
constexpr int kMaxCost = 32;
constexpr int kMaxR = 16;
constexpr int kMaxT = 64;
constexpr int kP = 8;  // behavioural parameters
// float(math.sqrt(5.0)), kernels.py's matern52 scalar
constexpr float kSqrt5 = 2.2360679774997896964f;

enum Kind { kLaplace = 0, kGaussian = 1, kMatern52 = 2 };

struct Args {
  const long long* order;
  const float *y, *xdot, *ydot, *xddot, *yddot, *res_norm, *steer, *kappa;
  const float *params, *beta, *sigma, *x_roll, *y_roll, *x_obs, *y_obs, *z, *mean, *cov,
      *v_des;
  float *mean_out, *cov_out, *params_out, *res, *res_2, *risk_obs_best, *risk_lane_best;
  long long *best, *kept_out, *elites_out;
  long long* clock;  // phase stamps of each CTA's thread 0 (null: none)
  int nb, n_cost, n_el, R, T, num, nobs, obs_len, maxiter, it, kind, frenet, with_des;
  float inv_a2, inv_b2, y_lb, y_ub, ker_wt, w_obs, w_lane, w_des, y_des1, y_des2,
      gamma_lane_des, steer_max, w_des_lane, w_centr, a_centr, inv_lamda, a_m1, a_m, a_c1,
      a_c, jitter, v_min, v_max;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// kernels.kernel_of at distance d (d2 = d d) and bandwidth sigma
__device__ __forceinline__ float kernel_value(int kind, float d, float sigma) {
  if (kind == kLaplace) return expf(dvd(-d, sigma));
  const float d2 = mul(d, d), s2 = mul(sigma, sigma);
  if (kind == kGaussian) return expf(dvd(-d2, mul(2.0f, s2)));
  const float r1 = dvd(mul(kSqrt5, d), sigma);
  return mul(add(add(1.0f, r1), dvd(mul(5.0f, d2), mul(3.0f, s2))), expf(-r1));
}

// kernels.mmd_vs_zero of one candidate, by one warp: beta (R) in global
// memory, the samples c (R) in shared memory; flat its index in the
// (..., R, R) product tensor of the plain chain (for the vectorised sum's
// alignment past R^2 = 128)
__device__ float mmd_vs_zero(const float* beta, const float* c, float sigma, int R, int kind,
                             float ker_wt, long long flat, int lane) {
  const int RR = R * R;
  const float quad = mmd_order::row_reduce(
      [&](int q) {
        const int i = q / R, j = q % R;
        const float K = kernel_value(kind, fabsf(sub(c[i], c[j])), sigma);
        return mul(mul(beta[i], K), beta[j]);
      },
      RR, static_cast<int>((flat * RR) % 4), Add(), lane);
  const float cross = mmd_order::row_reduce(
      [&](int i) { return mul(beta[i], kernel_value(kind, fabsf(c[i]), sigma)); }, R,
      static_cast<int>((flat * R) % 4), Add(), lane);
  return mul(ker_wt, sub(quad, mul(2.0f, cross)));
}

// warp max of v >= 0, NaN if any lane's is NaN (amax)
__device__ __forceinline__ float warp_amax(float v) {
  const bool nan = __any_sync(kFull, v != v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return nan ? __int_as_float(0x7fffffff) : v;
}

// the stable ascending rank of v[i] among v[0..n): NaN last, ties by index
__device__ __forceinline__ int stable_rank(const float* v, int n, int i) {
  const float x = v[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) {
    const float y = v[j];
    const bool less = (y < x) || (x != x && y == y);
    const bool equal = !less && !((x < y) || (y != y && x == x));
    rank += less || (equal && j < i);
  }
  return rank;
}

__device__ __forceinline__ void stamp(const Args& a, int k) {
  if (a.clock != nullptr && threadIdx.x == 0) a.clock[blockIdx.x * 8 + k] = clock64();
}

__global__ void __launch_bounds__(kThreads) outer_tail_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / cs;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nb = a.nb, R = a.R, T = a.T, nobs = a.nobs, n_cost = a.n_cost, n_el = a.n_el;

  __shared__ float risk[kMaxNb];
  __shared__ float viol[kMaxNb * kMaxR];  // this CTA's candidates' violations
  extern __shared__ float obs[];              // x_obs | y_obs, nobs x T each
  __shared__ int kept[kMaxCost];
  __shared__ float lane_r[kMaxCost], des_r[kMaxCost], cost[kMaxCost];
  __shared__ int elite[kMaxCost];
  __shared__ float w[kMaxCost], mean[kP], cov[kP * kP], L[kP * kP];
  __shared__ float lb_ub[kWarps][2 * kMaxR];
  __shared__ int pick;

  stamp(a, 0);
  for (int q = threadIdx.x; q < nobs * T; q += kThreads) {
    const int o = q / T, t = q % T;
    obs[q] = a.x_obs[(static_cast<size_t>(n) * nobs + o) * a.obs_len + t];
    obs[nobs * T + q] = a.y_obs[(static_cast<size_t>(n) * nobs + o) * a.obs_len + t];
  }
  // this CTA's candidates [i0, i1)
  const int per = (nb + cs - 1) / cs;
  const int i0 = rank * per, i1 = min(nb, i0 + per);
  __syncthreads();

  // ---- 1. the obstacle risk of this CTA's candidates ----
  for (int q = warp; q < (i1 - i0) * R; q += kWarps) {
    const int i = i0 + q / R, r = q % R;
    const size_t base = ((static_cast<size_t>(n) * nb + i) * R + r) * T;
    float m = 0.0f;
    for (int t = lane; t < T; t += kWarp) {
      const float xr = a.x_roll[base + t], yr = a.y_roll[base + t];
      for (int o = 0; o < nobs; ++o) {
        const float dx = sub(xr, obs[o * T + t]), dy = sub(yr, obs[nobs * T + o * T + t]);
        const float c = clamp_min(
            sub(sub(1.0f, mul(mul(dx, dx), a.inv_a2)), mul(mul(dy, dy), a.inv_b2)), 0.0f);
        m = c != c ? c : m != m ? m : fmaxf(m, c);
      }
    }
    const float v = warp_amax(m);
    if (lane == 0) viol[q] = v;
  }
  __syncthreads();
  for (int i = i0 + warp; i < i1; i += kWarps) {
    const size_t ci = static_cast<size_t>(n) * nb + i;
    const float rk = mmd_vs_zero(a.beta + ci * R, viol + (i - i0) * R, a.sigma[ci], R, a.kind,
                                 a.ker_wt, static_cast<long long>(ci), lane);
    if (lane == 0) risk[i] = rk;
  }
  stamp(a, 1);
  cluster.sync();
  if (rank == 0) {
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const int owner = i / per;
      if (owner != 0) risk[i] = *cluster.map_shared_rank(&risk[i], owner);
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 may read its risks
  if (rank != 0) return;
  __syncthreads();

  // ---- 2. the n_cost least risks ----
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int rk = stable_rank(risk, nb, i);
    if (rk < n_cost) kept[rk] = i;
  }
  __syncthreads();
  stamp(a, 2);

  // a kept candidate's projection row
  const long long* ord = a.order + static_cast<size_t>(n) * nb;
  auto row_of = [&](int i) { return static_cast<size_t>(n) * nb + ord[i]; };

  // ---- 3. the lane risks of the kept ----
  for (int k = warp; k < n_cost; k += kWarps) {
    const int i = kept[k];
    const size_t ci = static_cast<size_t>(n) * nb + i;
    const float* yroll = a.y_roll + ci * R * T;
    for (int r = 0; r < R; ++r) {
      float ml = 0.0f, mu = 0.0f;
      for (int t = lane; t < T; t += kWarp) {
        const float yv = yroll[r * T + t];
        const float l = clamp_min(sub(a.y_lb, yv), 0.0f), u = clamp_min(sub(yv, a.y_ub), 0.0f);
        ml = l != l ? l : ml != ml ? ml : fmaxf(ml, l);
        mu = u != u ? u : mu != mu ? mu : fmaxf(mu, u);
      }
      ml = warp_amax(ml);
      mu = warp_amax(mu);
      if (lane == 0) {
        lb_ub[warp][r] = ml;
        lb_ub[warp][kMaxR + r] = mu;
      }
    }
    __syncwarp();
    const long long flat = static_cast<long long>(n) * n_cost + k;
    const float sg = a.sigma[ci];
    const float lane_k = add(mmd_vs_zero(a.beta + ci * R, lb_ub[warp], sg, R, a.kind, a.ker_wt,
                                         flat, lane),
                             mmd_vs_zero(a.beta + ci * R, lb_ub[warp] + kMaxR, sg, R, a.kind,
                                         a.ker_wt, flat, lane));
    float des = 0.0f;
    if (a.with_des) {
      const int RT = R * T, shift = static_cast<int>((flat * RT) % 4);
      const float n1 = sqrtf(mmd_order::row_reduce(
          [&](int q) { return sub(yroll[q], a.y_des1); }, RT, shift, Square(), lane));
      const float n2 = sqrtf(mmd_order::row_reduce(
          [&](int q) { return sub(yroll[q], a.y_des2); }, RT, shift, Square(), lane));
      const float bar = clamp_min(sub(mul(n1, n2), a.gamma_lane_des), 0.0f);
      __syncwarp();
      if (lane < R) lb_ub[warp][lane] = bar;
      __syncwarp();
      des = mul(a.w_des,
                mmd_vs_zero(a.beta + ci * R, lb_ub[warp], sg, R, a.kind, a.ker_wt, flat, lane));
    }
    __syncwarp();
    if (lane == 0) {
      lane_r[k] = lane_k;
      des_r[k] = des;
    }
  }
  __syncthreads();
  stamp(a, 3);

  // ---- 4. the scalar cost of the kept ----
  const int num = a.num;
  for (int k = warp; k < n_cost; k += kWarps) {
    const int i = kept[k];
    const size_t rb = row_of(i) * num;
    const float *s = a.steer + rb, *yv = a.y + rb, *xd = a.xdot + rb, *yd = a.ydot + rb;
    const float *xdd = a.xddot + rb, *ydd = a.yddot + rb;
    const long long flat = static_cast<long long>(n) * n_cost + k;
    auto norm = [&](auto t, int len) {
      return sqrtf(mmd_order::row_reduce(t, len, static_cast<int>((flat * len) % 4), Square(),
                                         lane));
    };
    auto sv = [&](int q) { return sub(s[q + 1], s[q]); };
    const float vdes = a.v_des[0];
    const float c_vel = norm([&](int q) {
      return sub(sqrtf(add(mul(xd[q], xd[q]), mul(yd[q], yd[q]))), vdes);
    }, num);
    const float c_s = norm([&](int q) { return s[q]; }, num);
    const float c_sv = norm(sv, num - 1);
    const float c_sa = norm([&](int q) { return sub(sv(q + 1), sv(q)); }, num - 2);
    const float c_pen = norm([&](int q) { return clamp_min(sub(fabsf(s[q]), a.steer_max), 0.0f); },
                             num);
    const float c_vpen = norm([&](int q) { return clamp_min(sub(fabsf(sv(q)), 0.05f), 0.0f); },
                              num - 1);
    const float c_ydd = norm([&](int q) { return ydd[q]; }, num);
    const float c_xdd = norm([&](int q) { return xdd[q]; }, num);
    const float risk_w = mul(a.w_obs, risk[i]), lane_w = mul(a.w_lane, lane_r[k]);
    float base = add(a.res_norm[row_of(i)], mul(0.1f, c_vel));
    base = add(base, mul(0.1f, add(add(c_s, c_sv), c_sa)));
    base = add(base, mul(0.1f, add(c_pen, c_vpen)));
    base = add(base, mul(0.02f, c_ydd));
    base = add(base, mul(0.02f, c_xdd));
    float c;
    if (!a.frenet) {
      c = add(add(base, risk_w), mul(0.0f, lane_w));
    } else {
      const float* kp = a.kappa + rb;
      base = add(add(base, 0.0f), mul(0.0f, 0.0f));
      const float c1 = norm([&](int q) { return sub(yv[q], a.y_des1); }, num);
      const float c2 = norm([&](int q) { return sub(yv[q], a.y_des2); }, num);
      const float cc = norm([&](int q) {
        return clamp_min(sub(fabsf(mul(mul(xd[q], xd[q]), kp[q])), a.a_centr), 0.0f);
      }, num);
      c = add(base, mul(mul(a.w_des_lane, c1), c2));
      c = add(c, mul(a.w_centr, cc));
      c = add(add(add(c, risk_w), lane_w), des_r[k]);
    }
    if (lane == 0) cost[k] = c;
  }
  __syncthreads();
  stamp(a, 4);

  // ---- 5. the elites; 6. cem_update; 7. the pick ----
  if (threadIdx.x < n_cost) {
    const int rk = stable_rank(cost, n_cost, threadIdx.x);
    if (rk < n_el) elite[rk] = threadIdx.x;
  }
  __syncthreads();
  // the elites' parameters: kept candidate elite[e], projection row
  auto pe = [&](int e, int j) {
    return a.params[(static_cast<size_t>(n) * nb + ord[kept[elite[e]]]) * kP + j];
  };
  if (threadIdx.x == 0) {
    float cmin = cost[elite[0]];
    int at = -1;
    for (int e = 0; e < n_el; ++e) {
      const float c = cost[elite[e]];
      if (c != c) {
        if (at < 0) at = e;
        cmin = c;
      } else if (cmin == cmin) {
        cmin = fminf(cmin, c);
      }
    }
    pick = at < 0 ? 0 : at;
    for (int e = 0; e < n_el; ++e) w[e] = expf(mul(-sub(cost[elite[e]], cmin), a.inv_lamda));
    a.res[static_cast<size_t>(n) * a.maxiter + a.it] = cmin;
  }
  __syncthreads();
  const float sum_w = mmd_order::small_reduce([&](int e) { return w[e]; }, n_el, Add());
  if (threadIdx.x < kP) {
    const int j = threadIdx.x;
    const float s = mmd_order::strided_sum([&](int e) { return mul(pe(e, j), w[e]); }, n_el);
    mean[j] = add(mul(a.a_m1, a.mean[n * kP + j]), mul(a.a_m, dvd(s, sum_w)));
  }
  __syncthreads();
  if (threadIdx.x < kP * kP) {
    const int i = threadIdx.x / kP, j = threadIdx.x % kP;
    const float s = mmd_order::strided_sum(
        [&](int e) {
          return mul(mul(w[e], sub(pe(e, i), mean[i])), sub(pe(e, j), mean[j]));
        },
        n_el);
    const float cw = dvd(s, sum_w);
    cov[threadIdx.x] = add(add(mul(a.a_c1, a.cov[n * kP * kP + threadIdx.x]), mul(a.a_c, cw)),
                           mul(a.jitter, i == j ? 1.0f : 0.0f));
    L[threadIdx.x] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // cuSOLVER's batched potrf, all NaN past a pivot <= 0
    bool ok = true;
    for (int j = 0; j < kP; ++j) {
      float piv = cov[j * kP + j];
      for (int p = 0; p < j; ++p) piv = __fmaf_rn(-L[j * kP + p], L[j * kP + p], piv);
      ok = ok && piv > 0.0f;
      const float d = __fsqrt_rn(piv), r = dvd(1.0f, d);
      L[j * kP + j] = d;
      for (int i = j + 1; i < kP; ++i) {
        float t = cov[i * kP + j];
        for (int p = 0; p < j; ++p) t = __fmaf_rn(-L[i * kP + p], L[j * kP + p], t);
        L[i * kP + j] = mul(t, r);
      }
    }
    if (!ok)
      for (int q = 0; q < kP * kP; ++q) L[q] = __int_as_float(0x7fffffff);
  }
  __syncthreads();
  stamp(a, 5);
  const size_t pb = static_cast<size_t>(n) * nb * kP;
  const float* zn = a.z + static_cast<size_t>(n) * (nb - n_el) * kP;
  for (int q = threadIdx.x; q < nb * kP; q += kThreads) {
    const int r = q / kP, j = q % kP;
    float v;
    if (r < n_el) {
      v = pe(r, j);
    } else {
      const float* zr = zn + (r - n_el) * kP;
      // matmul_rows(z, L^T): the product tensor is contiguous, so the sum
      // runs along a strided axis, term k into accumulator k % 4
      v = add(mean[j], mmd_order::strided_sum([&](int k) { return mul(zr[k], L[j * kP + k]); },
                                              kP));
      if (j < 4) v = clamp(v, a.v_min, a.v_max);
    }
    a.params_out[pb + q] = v;
  }
  if (threadIdx.x < kP) a.mean_out[n * kP + threadIdx.x] = mean[threadIdx.x];
  if (threadIdx.x < kP * kP) a.cov_out[n * kP * kP + threadIdx.x] = cov[threadIdx.x];
  if (threadIdx.x == 0) {
    const int i = kept[pick];
    a.res_2[static_cast<size_t>(n) * a.maxiter + a.it] = a.res_norm[row_of(i)];
    a.best[n] = i;
    a.risk_obs_best[n] = risk[i];
    a.risk_lane_best[n] = lane_r[pick];
  }
  if (threadIdx.x < n_cost) a.kept_out[n * n_cost + threadIdx.x] = kept[threadIdx.x];
  if (threadIdx.x < n_el) a.elites_out[n * n_el + threadIdx.x] = elite[threadIdx.x];
  stamp(a, 6);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

int last_cluster = 0;

}  // namespace

// The cluster size a launch of N scenarios takes: the largest of 8, 4, 2
// whose N clusters fit the card's SMs at one CTA an SM, else 1.
extern "C" int mmd_outer_tail_cluster(int N) {
  for (int cs = 8; cs > 1; cs /= 2)
    if (N * cs <= sm_count()) return cs;
  return 1;
}

// The cluster size of the last launch.
extern "C" int mmd_outer_tail_last_cluster() { return last_cluster; }

// Inputs as ops/outer_tail.py passes them; cs the cluster size (0: the
// size mmd_outer_tail_cluster picks); clock null, or N cs x 8 int64 for
// clock64 stamps of each CTA's thread 0 at its phases.
extern "C" int mmd_outer_tail(
    const long long* order, const float* y, const float* xdot, const float* ydot,
    const float* xddot, const float* yddot, const float* res_norm, const float* steer,
    const float* kappa, const float* params, const float* beta, const float* sigma,
    const float* x_roll, const float* y_roll, const float* x_obs, const float* y_obs,
    const float* z, const float* mean, const float* cov, const float* v_des, float* mean_out,
    float* cov_out, float* params_out, float* res, float* res_2, float* risk_obs_best,
    float* risk_lane_best, long long* best, long long* kept_out, long long* elites_out,
    long long* clock, int N, int nb, int n_cost,
    int n_el, int R, int T, int num, int nobs, int obs_len, int maxiter, int it, int kind,
    int frenet, int with_des, int cs, float inv_a2, float inv_b2, float y_lb, float y_ub,
    float ker_wt, float w_obs, float w_lane, float w_des, float y_des1, float y_des2,
    float gamma_lane_des, float steer_max, float w_des_lane, float w_centr, float a_centr,
    float inv_lamda, float a_m1, float a_m, float a_c1, float a_c, float jitter, float v_min,
    float v_max, void* stream) {
  if (N <= 0) return 0;
  if (nb < 2 || nb > kMaxNb || n_cost < 1 || n_cost > kMaxCost || n_cost > nb || n_el < 1 ||
      n_el > n_cost || R < 1 || R > kMaxR || T < 1 || T > kMaxT || num < 3 || num > 4096 ||
      nobs < 1 || obs_len < T || it < 0 || it >= maxiter || kind < kLaplace ||
      kind > kMatern52 || (frenet && kappa == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cs == 0) cs = mmd_outer_tail_cluster(N);
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{order, y, xdot, ydot, xddot, yddot, res_norm, steer, kappa, params, beta, sigma,
               x_roll, y_roll, x_obs, y_obs, z, mean, cov, v_des, mean_out, cov_out, params_out,
               res, res_2, risk_obs_best, risk_lane_best, best, kept_out, elites_out, clock,
               nb, n_cost, n_el, R, T,
               num, nobs, obs_len, maxiter, it, kind, frenet, with_des, inv_a2, inv_b2, y_lb,
               y_ub, ker_wt, w_obs, w_lane, w_des, y_des1, y_des2, gamma_lane_des, steer_max,
               w_des_lane, w_centr, a_centr, inv_lamda, a_m1, a_m, a_c1, a_c, jitter, v_min,
               v_max};
  last_cluster = cs;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(N * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(2 * nobs * T) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, outer_tail_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
