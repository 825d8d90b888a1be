// Kernel (e): an outer CEM iteration's step from the reduced sets to the
// next parameters, for every scenario of a chunk in one launch.
//
// Replaces what XLA fuses from the JAX package's outer iteration
// (mpc_mmd_tpu/solver.py:235-300, solver_frenet.py:199-257: the obstacle
// risk, the sort by risk, the lane risks, the scalar cost, the sort by
// cost, cem_update at sampling.py:74, the best candidate), which the port
// ran as about 150 PyTorch launches an outer iteration plus the sorts and
// gathers (ops/outer_tail.py's plain version: the mode's risk.*_obs, then
// sampling.cem_tail).  Like kernels (a)-(d) it replaces an XLA lowering.
//
// The risk form is a template argument (MODE): the MMD with reduced sets
// (mmd_opt), the MMD with the uniform weights and bandwidth the solver
// gives (mmd_random, whose lane risk is zero on the straight road), CVaR
// (risk.cvar_reduce: the mean of the samples at or above their linear
// alpha-quantile), SAA (the count of positive samples times the float32
// reciprocal of num_reduced) and none (det: every risk zero, no rollout
// read).
//
// Per scenario n of N, with the candidates in the order of the
// projection residual (position i is projection row n nb + order[n, i]):
//   1. the obstacle risk of every candidate: the violation of each reduced
//      rollout (the largest of clamp(1 - dx^2 / a^2 - dy^2 / b^2, 0) over
//      the obstacles and the steps) and the mode's reduction of the
//      candidate's violations (its MMD against zero with its beta and
//      sigma, CVaR or SAA);
//   2. the n_cost least risks, by a stable sort (NaN last, ties by index);
//   3. their lane risk (the mode's reduction of the lower and of the upper
//      lane violations, summed) and, on the road where weight_lane_des is
//      not 0, the weighted desired-lane risk;
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
// float32 reciprocal), so that the kernel gives its bits.  CVaR's
// quantile is torch.quantile's on the card: the values at the sorted
// positions floor and ceil of the float32 rank q (R - 1), joined by
// ATen's lerp with the weight rank - floor (cvar_reduce below); a row with
// a NaN has a NaN quantile, so no sample passes the >= mask and its CVaR
// is 0.
//
// What bounds it on the card: per scenario it reads the reduced rollouts
// (nb R T floats twice: 0.26 MB at fastrt) and the candidates' rows,
// and evaluates nb R num_obs T violations (3.2e5 at fastrt) and nb R^2
// kernel values: microseconds of either over the card, but the steps
// after the risk are a chain of small dependent phases.  A scenario is a
// thread-block cluster of cs CTAs (1, 2, 4 or 8; the kernel picks the
// size, utils/kernel_ab.py times them), and the chain is spread over it:
// each CTA scores its share of the candidates' risks (phase 1); every CTA
// reads all the risks through distributed shared memory and ranks them
// itself (a rank is a function of the risks alone, so every CTA keeps the
// same candidates); kept candidate k goes to CTA k mod cs, where one warp
// a rollout takes its lane violations, one warp a norm its cost's norms
// and desired-lane norms, then one warp an MMD its lane risks (phases 3
// and 4); each CTA writes its candidates' lane risks and costs into rank
// 0's shared memory, and after one cluster barrier rank 0 runs phases 5-7,
// the Cholesky factor by one warp (a lane a row, each entry's chain of
// fused multiply-adds in cuSOLVER's order).

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
constexpr int kMaxT = 64;   // two steps a lane
constexpr int kBatch = 4;   // rollouts a warp loads at once in phase 1
constexpr int kP = 8;  // behavioural parameters
constexpr int kNorms = 11;  // a kept candidate's cost norms (8, and 3 on the road)
// float(math.sqrt(5.0)), kernels.py's matern52 scalar
constexpr float kSqrt5 = 2.2360679774997896964f;

enum Kind { kLaplace = 0, kGaussian = 1, kMatern52 = 2 };
// the risk forms, in ops/outer_tail.py's MODES order
enum Mode { kMmdOpt = 0, kMmdRandom = 1, kCvar = 2, kSaa = 3, kDet = 4 };

struct Args {
  const long long* order;
  const float *y, *xdot, *ydot, *xddot, *yddot, *res_norm, *steer, *kappa;
  const float *params, *beta, *sigma, *x_roll, *y_roll, *x_obs, *y_obs, *z, *mean, *cov,
      *v_des;
  float *mean_out, *cov_out, *params_out, *res, *res_2, *risk_obs_best, *risk_lane_best;
  long long *best, *kept_out, *elites_out;
  long long* clock;     // phase stamps of each CTA's thread 0 (null: none)
  long long* kept_cta;  // each CTA's kept candidates (null: none)
  int nb, n_cost, n_el, R, T, num, nobs, obs_len, maxiter, it, kind, frenet, with_des;
  float inv_a2, inv_b2, y_lb, y_ub, ker_wt, w_obs, w_lane, w_des, y_des1, y_des2,
      gamma_lane_des, steer_max, w_des_lane, w_centr, a_centr, inv_lamda, a_m1, a_m, a_c1,
      a_c, jitter, v_min, v_max;
  // CVaR's quantile positions and weights (alpha_quant; alpha_quant_lane
  // for the desired lane), SAA's 1 / num_reduced
  int q_lo, q_hi, q_lo_des, q_hi_des;
  float q_w, q_w_des, inv_R;
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

// ATen's lerp (Lerp.h): a + w (b - a) for |w| < 0.5, else b - (b - a) (1 - w),
// each product and sum contracted into one fused multiply-add as PyTorch's
// build of it computes them (torch.lerp on the H100 matched this form at
// every one of 2^20 inputs a weight, and torch.quantile with it)
__device__ __forceinline__ float lerp_aten(float a, float b, float w) {
  return fabsf(w) < 0.5f ? __fmaf_rn(w, sub(b, a), a) : __fmaf_rn(sub(a, b), sub(1.0f, w), b);
}

// risk.cvar_reduce of the R samples s, by one thread: torch.quantile's
// linear interpolation between sorted positions lo and hi with weight w
// (a stable sort: the value at a position is the same whichever of a tie
// lands there), the mean of the samples >= it; 0 if a sample is NaN
__device__ float cvar_reduce(const float* s, int R, int lo, int hi, float w) {
  float vlo = 0.0f, vhi = 0.0f;
  for (int i = 0; i < R; ++i) {
    const float x = s[i];
    if (x != x) return 0.0f;
    int rank = 0;
    for (int j = 0; j < R; ++j) rank += s[j] < x || (s[j] == x && j < i);
    if (rank == lo) vlo = x;
    if (rank == hi) vhi = x;
  }
  const float var = lerp_aten(vlo, vhi, w);
  int n = 0;
  for (int i = 0; i < R; ++i) n += s[i] >= var;
  const float sum = mmd_order::small_reduce([&](int i) { return s[i] >= var ? s[i] : 0.0f; },
                                            R, Add());
  return n > 0 ? dvd(sum, static_cast<float>(n)) : 0.0f;
}

// risk.saa_reduce of the R samples s, by one thread: the count of
// positive samples times the float32 1 / num_reduced
__device__ __forceinline__ float saa_reduce(const float* s, int R, float inv_R) {
  int n = 0;
  for (int i = 0; i < R; ++i) n += s[i] > 0.0f;
  return mul(static_cast<float>(n), inv_R);
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

template <int MODE>
__global__ void __launch_bounds__(kThreads) outer_tail_kernel(const Args a) {
  constexpr bool kMmd = MODE == kMmdOpt || MODE == kMmdRandom;
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
  __shared__ float lane_r[kMaxCost], cost[kMaxCost];
  __shared__ int elite[kMaxCost];
  __shared__ float w[kMaxCost], mean[kP], cov[kP * kP], L[kP * kP];
  __shared__ int pick;
  __shared__ float elite_p[kMaxCost * kP];
  // this CTA's kept candidates (k = rank + q cs): per rollout the lower and
  // upper lane violations, the cost's norms (kNorms), the desired-lane
  // norms and the three MMDs (lower, upper, desired lane)
  __shared__ float lb_ub[kMaxCost][2 * kMaxR];
  __shared__ float norms[kMaxCost][kNorms + 2];
  __shared__ float mmds[kMaxCost][3];
  __shared__ float bar_des[kWarps][kMaxR];

  stamp(a, 0);
  for (int q = threadIdx.x; MODE != kDet && q < nobs * T; q += kThreads) {
    const int o = q / T, t = q % T;
    obs[q] = a.x_obs[(static_cast<size_t>(n) * nobs + o) * a.obs_len + t];
    obs[nobs * T + q] = a.y_obs[(static_cast<size_t>(n) * nobs + o) * a.obs_len + t];
  }
  // this CTA's candidates [i0, i1)
  const int per = (nb + cs - 1) / cs;
  const int i0 = rank * per, i1 = min(nb, i0 + per);
  __syncthreads();

  // ---- 1. the obstacle risk of this CTA's candidates ----
  // rollout q of the CTA's (i1 - i0) R; a warp loads kBatch of its
  // rollouts (T <= 64: two steps a lane) before it scores them
  const int nq = MODE == kDet ? 0 : (i1 - i0) * R;
  const float* xs = a.x_roll + (static_cast<size_t>(n) * nb + i0) * R * T;
  const float* ys = a.y_roll + (static_cast<size_t>(n) * nb + i0) * R * T;
  for (int q0 = warp; q0 < nq; q0 += kWarps * kBatch) {
    float xr[kBatch][2], yr[kBatch][2];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + u * kWarps, t = lane + h * kWarp;
        const bool in = q < nq && t < T;
        xr[u][h] = in ? xs[static_cast<size_t>(q) * T + t] : 0.0f;
        yr[u][h] = in ? ys[static_cast<size_t>(q) * T + t] : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u * kWarps;
      if (q >= nq) break;
      float m = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = lane + h * kWarp;
        if (t >= T) continue;
        for (int o = 0; o < nobs; ++o) {
          const float dx = sub(xr[u][h], obs[o * T + t]);
          const float dy = sub(yr[u][h], obs[nobs * T + o * T + t]);
          const float c = clamp_min(
              sub(sub(1.0f, mul(mul(dx, dx), a.inv_a2)), mul(mul(dy, dy), a.inv_b2)), 0.0f);
          m = c != c ? c : m != m ? m : fmaxf(m, c);
        }
      }
      const float v = warp_amax(m);
      if (lane == 0) viol[q] = v;
    }
  }
  __syncthreads();
  if constexpr (kMmd) {  // a warp a candidate
    for (int i = i0 + warp; i < i1; i += kWarps) {
      const size_t ci = static_cast<size_t>(n) * nb + i;
      const float rk = mmd_vs_zero(a.beta + ci * R, viol + (i - i0) * R, a.sigma[ci], R,
                                   a.kind, a.ker_wt, static_cast<long long>(ci), lane);
      if (lane == 0) risk[i] = rk;
    }
  } else {  // a thread a candidate
    for (int i = i0 + static_cast<int>(threadIdx.x); i < i1; i += kThreads) {
      const float* v = viol + (i - i0) * R;
      risk[i] = MODE == kCvar  ? cvar_reduce(v, R, a.q_lo, a.q_hi, a.q_w)
                : MODE == kSaa ? saa_reduce(v, R, a.inv_R)
                               : 0.0f;
    }
  }
  stamp(a, 1);
  cluster.sync();

  // ---- 2. every CTA: all the risks, the n_cost least ----
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int owner = i / per;
    if (owner != rank) risk[i] = *cluster.map_shared_rank(&risk[i], owner);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    const int rk = stable_rank(risk, nb, i);
    if (rk < n_cost) kept[rk] = i;
  }
  __syncthreads();
  if (a.kept_cta != nullptr && threadIdx.x < n_cost)
    a.kept_cta[static_cast<size_t>(blockIdx.x) * n_cost + threadIdx.x] = kept[threadIdx.x];
  stamp(a, 2);

  // a kept candidate's projection row
  const long long* ord = a.order + static_cast<size_t>(n) * nb;
  auto row_of = [&](int i) { return static_cast<size_t>(n) * nb + ord[i]; };

  // ---- 3. and 4. the lane risks and the costs of this CTA's kept ----
  const int nk = (n_cost - rank + cs - 1) / cs;  // k = rank + q cs, q < nk
  const int num = a.num;
  const int n_norms = a.frenet ? kNorms : 8, n_des = a.with_des ? 2 : 0;
  // det has no lane risk, nor has mmd_random on the straight road
  const bool lane_on = MODE != kDet && !(MODE == kMmdRandom && !a.frenet);
  const int n_lane = lane_on ? R : 0;
  const int tasks = n_lane + n_des + n_norms;  // a kept candidate's warps before its risks
  for (int task = warp; task < nk * tasks; task += kWarps) {
    const int q = task / tasks, sub_task = task % tasks, k = rank + q * cs;
    const int i = kept[k];
    const size_t ci = static_cast<size_t>(n) * nb + i;
    const float* yroll = a.y_roll + ci * R * T;
    const long long flat = static_cast<long long>(n) * n_cost + k;
    if (sub_task < n_lane) {  // the lane violations of rollout sub_task
      const int r = sub_task;
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
        lb_ub[q][r] = ml;
        lb_ub[q][kMaxR + r] = mu;
      }
    } else if (sub_task < n_lane + n_des) {  // a desired-lane norm over the R T points
      const int RT = R * T, shift = static_cast<int>((flat * RT) % 4);
      const float yd = sub_task == n_lane ? a.y_des1 : a.y_des2;
      const float v = sqrtf(mmd_order::row_reduce(
          [&](int p) { return sub(yroll[p], yd); }, RT, shift, Square(), lane));
      if (lane == 0) norms[q][kNorms + sub_task - n_lane] = v;
    } else {  // a norm of the scalar cost
      const int c = sub_task - n_lane - n_des;
      const size_t rb = row_of(i) * num;
      const float *s = a.steer + rb, *yv = a.y + rb, *xd = a.xdot + rb, *yd = a.ydot + rb;
      const float *xdd = a.xddot + rb, *ydd = a.yddot + rb;
      const float* kp = a.frenet ? a.kappa + rb : nullptr;
      auto norm = [&](auto f, int len) {
        return sqrtf(mmd_order::row_reduce(f, len, static_cast<int>((flat * len) % 4),
                                           Square(), lane));
      };
      auto sv = [&](int p) { return sub(s[p + 1], s[p]); };
      float v = 0.0f;
      switch (c) {
        case 0: {
          const float vdes = a.v_des[0];
          v = norm([&](int p) { return sub(sqrtf(add(mul(xd[p], xd[p]), mul(yd[p], yd[p]))), vdes); },
                   num);
          break;
        }
        case 1: v = norm([&](int p) { return s[p]; }, num); break;
        case 2: v = norm(sv, num - 1); break;
        case 3: v = norm([&](int p) { return sub(sv(p + 1), sv(p)); }, num - 2); break;
        case 4:
          v = norm([&](int p) { return clamp_min(sub(fabsf(s[p]), a.steer_max), 0.0f); }, num);
          break;
        case 5:
          v = norm([&](int p) { return clamp_min(sub(fabsf(sv(p)), 0.05f), 0.0f); }, num - 1);
          break;
        case 6: v = norm([&](int p) { return ydd[p]; }, num); break;
        case 7: v = norm([&](int p) { return xdd[p]; }, num); break;
        case 8: v = norm([&](int p) { return sub(yv[p], a.y_des1); }, num); break;
        case 9: v = norm([&](int p) { return sub(yv[p], a.y_des2); }, num); break;
        default:
          v = norm([&](int p) {
            return clamp_min(sub(fabsf(mul(mul(xd[p], xd[p]), kp[p])), a.a_centr), 0.0f);
          }, num);
      }
      if (lane == 0) norms[q][c] = v;
    }
  }
  __syncthreads();
  stamp(a, 3);
  const int n_mmd = lane_on ? (a.with_des ? 3 : 2) : 0;  // the lane risks a kept
  for (int task = warp; task < nk * n_mmd; task += kWarps) {
    const int q = task / n_mmd, m = task % n_mmd, k = rank + q * cs;
    const size_t ci = static_cast<size_t>(n) * nb + kept[k];
    const long long flat = static_cast<long long>(n) * n_cost + k;
    const float* samples = lb_ub[q] + (m == 1 ? kMaxR : 0);
    if (m == 2) {  // the desired-lane barrier, the same at every rollout
      const float bar = clamp_min(sub(mul(norms[q][kNorms], norms[q][kNorms + 1]),
                                      a.gamma_lane_des), 0.0f);
      if (lane < R) bar_des[warp][lane] = bar;
      __syncwarp();
      samples = bar_des[warp];
    }
    if constexpr (kMmd) {
      const float v = mmd_vs_zero(a.beta + ci * R, samples, a.sigma[ci], R, a.kind, a.ker_wt,
                                  flat, lane);
      if (lane == 0) mmds[q][m] = v;
    } else if (lane == 0) {
      mmds[q][m] = MODE == kCvar ? (m == 2 ? cvar_reduce(samples, R, a.q_lo_des, a.q_hi_des,
                                                         a.q_w_des)
                                           : cvar_reduce(samples, R, a.q_lo, a.q_hi, a.q_w))
                                 : saa_reduce(samples, R, a.inv_R);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nk; q += kThreads) {  // the costs, into rank 0's memory
    const int k = rank + q * cs, i = kept[k];
    const float* c = norms[q];
    const float lane_k = lane_on ? add(mmds[q][0], mmds[q][1]) : 0.0f;
    const float des = a.with_des ? mul(a.w_des, mmds[q][2]) : 0.0f;
    const float risk_w = mul(a.w_obs, risk[i]), lane_w = mul(a.w_lane, lane_k);
    float base = add(a.res_norm[row_of(i)], mul(0.1f, c[0]));
    base = add(base, mul(0.1f, add(add(c[1], c[2]), c[3])));
    base = add(base, mul(0.1f, add(c[4], c[5])));
    base = add(base, mul(0.02f, c[6]));
    base = add(base, mul(0.02f, c[7]));
    float cst;
    if (!a.frenet) {
      cst = add(add(base, risk_w), mul(0.0f, lane_w));
    } else {
      base = add(add(base, 0.0f), mul(0.0f, 0.0f));
      cst = add(base, mul(mul(a.w_des_lane, c[8]), c[9]));
      cst = add(cst, mul(a.w_centr, c[10]));
      cst = add(add(add(cst, risk_w), lane_w), des);
    }
    *cluster.map_shared_rank(&lane_r[k], 0) = lane_k;
    *cluster.map_shared_rank(&cost[k], 0) = cst;
  }
  cluster.sync();  // the costs in rank 0; no CTA leaves while another reads its risks
  if (rank != 0) return;
  stamp(a, 4);

  // ---- 5. the elites; 6. cem_update; 7. the pick ----
  if (threadIdx.x < n_cost) {
    const int rk = stable_rank(cost, n_cost, threadIdx.x);
    if (rk < n_el) elite[rk] = threadIdx.x;
  }
  __syncthreads();
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
  // the elites' parameters (kept candidate elite[e], projection row), read
  // once, the other threads while thread 0 finds the least cost
  for (int q = threadIdx.x; q < n_el * kP; q += kThreads)
    elite_p[q] = a.params[(static_cast<size_t>(n) * nb + ord[kept[elite[q / kP]]]) * kP +
                          q % kP];
  auto pe = [&](int e, int j) { return elite_p[e * kP + j]; };
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
  }
  __syncthreads();
  if (warp == 0) {  // cuSOLVER's batched potrf, all NaN past a pivot <= 0: lane i row i
    float Lr[kP] = {};
    bool ok = true;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      float Lj[kP];
#pragma unroll
      for (int p = 0; p < j; ++p) Lj[p] = __shfl_sync(kFull, Lr[p], j);
      float piv = cov[j * kP + j];
#pragma unroll
      for (int p = 0; p < j; ++p) piv = __fmaf_rn(-Lj[p], Lj[p], piv);
      ok = ok && piv > 0.0f;
      const float d = __fsqrt_rn(piv), r = dvd(1.0f, d);
      if (lane == j) Lr[j] = d;
      if (lane > j && lane < kP) {
        float t = cov[lane * kP + j];
#pragma unroll
        for (int p = 0; p < j; ++p) t = __fmaf_rn(-Lr[p], Lj[p], t);
        Lr[j] = mul(t, r);
      }
    }
    if (lane < kP)
#pragma unroll
      for (int p = 0; p < kP; ++p) L[lane * kP + p] = ok ? Lr[p] : __int_as_float(0x7fffffff);
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

// Inputs as ops/outer_tail.py passes them; mode the risk form (Mode);
// beta and sigma null in cvar, saa and det, the rollouts and obstacles
// null in det; cs the cluster size (0: the size mmd_outer_tail_cluster
// picks); clock null, or N cs x 8 int64 for clock64 stamps of each CTA's
// thread 0 at its phases; kept_cta null, or N cs x n_cost int64 for the
// kept candidates each CTA ranked.
extern "C" int mmd_outer_tail(
    const long long* order, const float* y, const float* xdot, const float* ydot,
    const float* xddot, const float* yddot, const float* res_norm, const float* steer,
    const float* kappa, const float* params, const float* beta, const float* sigma,
    const float* x_roll, const float* y_roll, const float* x_obs, const float* y_obs,
    const float* z, const float* mean, const float* cov, const float* v_des, float* mean_out,
    float* cov_out, float* params_out, float* res, float* res_2, float* risk_obs_best,
    float* risk_lane_best, long long* best, long long* kept_out, long long* elites_out,
    long long* clock, long long* kept_cta, int N, int nb, int n_cost,
    int n_el, int R, int T, int num, int nobs, int obs_len, int maxiter, int it, int kind,
    int mode, int frenet, int with_des, int cs, float inv_a2, float inv_b2, float y_lb,
    float y_ub,
    float ker_wt, float w_obs, float w_lane, float w_des, float y_des1, float y_des2,
    float gamma_lane_des, float steer_max, float w_des_lane, float w_centr, float a_centr,
    float inv_lamda, float a_m1, float a_m, float a_c1, float a_c, float jitter, float v_min,
    float v_max, int q_lo, int q_hi, float q_w, int q_lo_des, int q_hi_des, float q_w_des,
    float inv_R, void* stream) {
  if (N <= 0) return 0;
  if (nb < 2 || nb > kMaxNb || n_cost < 1 || n_cost > kMaxCost || n_cost > nb || n_el < 1 ||
      n_el > n_cost || R < 1 || R > kMaxR || T < 1 || T > kMaxT || num < 3 || num > 4096 ||
      nobs < 1 || obs_len < T || it < 0 || it >= maxiter || kind < kLaplace ||
      kind > kMatern52 || (frenet && kappa == nullptr) || mode < kMmdOpt || mode > kDet ||
      q_lo < 0 || q_hi < q_lo || q_hi >= R || q_lo_des < 0 || q_hi_des < q_lo_des ||
      q_hi_des >= R || (mode != kDet && (x_roll == nullptr || y_roll == nullptr ||
                                         x_obs == nullptr || y_obs == nullptr)) ||
      ((mode == kMmdOpt || mode == kMmdRandom) && (beta == nullptr || sigma == nullptr)) ||
      (mode == kDet && with_des))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cs == 0) cs = mmd_outer_tail_cluster(N);
  if (cs != 1 && cs != 2 && cs != 4 && cs != 8) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{order, y, xdot, ydot, xddot, yddot, res_norm, steer, kappa, params, beta, sigma,
               x_roll, y_roll, x_obs, y_obs, z, mean, cov, v_des, mean_out, cov_out, params_out,
               res, res_2, risk_obs_best, risk_lane_best, best, kept_out, elites_out, clock,
               kept_cta, nb, n_cost, n_el, R, T,
               num, nobs, obs_len, maxiter, it, kind, frenet, with_des, inv_a2, inv_b2, y_lb,
               y_ub, ker_wt, w_obs, w_lane, w_des, y_des1, y_des2, gamma_lane_des, steer_max,
               w_des_lane, w_centr, a_centr, inv_lamda, a_m1, a_m, a_c1, a_c, jitter, v_min,
               v_max, q_lo, q_hi, q_lo_des, q_hi_des, q_w, q_w_des, inv_R};
  last_cluster = cs;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(N * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = mode == kDet ? 0 : static_cast<size_t>(2 * nobs * T) * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (mode) {
    case kMmdOpt: err = cudaLaunchKernelEx(&cfg, outer_tail_kernel<kMmdOpt>, a); break;
    case kMmdRandom: err = cudaLaunchKernelEx(&cfg, outer_tail_kernel<kMmdRandom>, a); break;
    case kCvar: err = cudaLaunchKernelEx(&cfg, outer_tail_kernel<kCvar>, a); break;
    case kSaa: err = cudaLaunchKernelEx(&cfg, outer_tail_kernel<kSaa>, a); break;
    default: err = cudaLaunchKernelEx(&cfg, outer_tail_kernel<kDet>, a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
