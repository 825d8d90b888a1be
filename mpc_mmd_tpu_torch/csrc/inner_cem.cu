// Kernel (c): the inner beta-CEM of every candidate, every iteration in one
// launch, under each of the inner CEM's selections ("xla", "xt", "fused",
// "g"), with elite-carry or without it: a form a selection.
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
// the dynamic workload's shape): microseconds of either.  What bounds it
// instead is the latency of each candidate's chain of iterations and how
// many warps run it.  The clock64 profile of the first design (one block
// of 8 warps a candidate, six block barriers an iteration; utils/
// kernel_ab.py's kc_clock_before, PERF.md) put 68-78 % of a block's cycles
// in phase B, a warp's k selected rows of D one after another (~1,400
// cycles each at M = 100), 14-20 % in the resample (A_t and Z_t read from
// device memory at the moment of use), 6-11 % in the top-k rounds and 1-4
// % in the QPs, the elite pick and the barriers; and a block a candidate
// left each SM 8 warps, on 64-100 of 132 SMs.  The design now:
// - a candidate is a thread-block cluster of 1, 2 or 4 CTAs, the size set
//   per launch (a launch attribute, cluster_size: the size whose grid
//   takes the fewest waves per CTA of a candidate by
//   cudaOccupancyMaxActiveClusters, a tie to the smaller: 2 at fastrt's 64
//   candidates, 1 at 100 and more).  A CTA owns a contiguous share of the
//   rows (all S at iteration 0, the S' fresh ones after) and their state;
//   the elites are kept in every CTA; the costs, the elites' rows,
//   indices and weights are read from their owners through distributed
//   shared memory, and every warp runs the same elite pick on the costs,
//   so nothing else is exchanged.  Rank 0 writes res, beta_w, idx_best and
//   sigma_w.  Two cluster barriers an iteration: after the QPs, and after
//   the elites' copy, whose wait comes only before a warp's first store of
//   a fresh row.  A candidate's bits depend on no other candidate and not
//   on the size: a chunk of scenarios equals each scenario alone;
// - a CTA has 16 warps where the QP's factor leaves room in 128 registers
//   a thread (k <= 10), else 8.  A warp takes its rows w, w + warps, ...
//   two at a time through the top-k rounds (A; their reductions
//   interleaved), each through B with J selected rows at once
//   (rows_at_once: all k up to 64 columns, half of them up to 128, two
//   past that; a single branch on the fast division for the J rows and the
//   kernel kind a template argument, so that their J x slots values are
//   one block of independent work: with the kind a run-time value, the
//   kernel is 7-39 % slower at the path shapes and builds no faster, and
//   these unrolled values, not the three kinds, set its build: about 175
//   CPU s, 134 at two rows at once, 78 for the first design), then its
//   lanes solve those rows' QPs, one a lane (C): no block barrier between
//   A, B and C;
// - a CTA's state is placed first fit in 227 KB of shared memory, the rest
//   in its slice of a device-memory scratch (Layout); up to M = 128 D and
//   D2 come first and always sit whole in every CTA, wider they come after
//   the rest, whole where they fit, else read from device memory (at M =
//   225: device memory);
// - the resample (E): a warp copies an elite from its owner, then writes
//   its own fresh rows, two at a time and every column slot at once, from
//   A_t and Z_t rows it staged with cp.async a whole iteration before.
// Measured (PERF.md, H100 at 700 W): 0.22 ms a launch at fastrt against
// 0.90 for the first design, 0.87 against 2.29 at the dynamic workload,
// 0.32 against 0.65 on the road, every output bit-equal to it.  What
// bounds it now, by the same clock64 profile: phase B is still the
// largest part of an iteration (43 % at fastrt, 53 % at the dynamic
// workload), then the resample with its cluster barrier (25 %); at N = 15
// (M = 225) B is 81 %: D's rows come from device memory, since D does not
// fit a CTA beside the rest of its state.
// No fast-math (the build's flags): the quotients, expf and the sums must
// round as PyTorch's do.
//
// The forms.  A row's selection and weight QP are a function of the row
// and D alone in every selection's chain (K1 and K3 work a row at a time,
// K2 a system at a time, the rest elementwise), so carrying the elites'
// results gives what recomputing them gives, and every selection runs the
// scheme above, as long as each row is computed in its selection's own
// arithmetic (a.form):
// - "xla": as above;
// - "fused" (K3's chain; a template argument, instantiated for laplace in
//   inner_cem_fused.cu): phases A and B in K3's arithmetic
//   (topk_kernel_rows.cuh): K3's rounds (no NaN mask: a row with a NaN
//   lane selects the sentinel M every round, whose D row and K_red column
//   are zero; a 3.0e38 mask, so an infinite lane wins every round) and
//   K3's row-sum order (each lane its columns, then the 32 partials 16
//   bytes at a time);
// - "xt" (K1, K2's lane-major entry): the same rows, the cost's two k-term
//   sums along the strided axis of its (k, rows) tensors (torch_order.cuh)
//   and r = float32(rho / M) row_sum;
// - "g" (every mother row's blocked exponential, then a gather): its K_red
//   from the features' L1 distances is D's entries (kernel (f)'s D is the
//   chain's pairwise_l1 of the same features, bit for bit), and its row sums
//   are the rows of its blocked exponential, the same terms.
// Where a row of D is summed depends on the form only from M = 128 on,
// where PyTorch's sum starts at the row's first 16-byte boundary: "xla" a
// (C, rows, k, M) tensor, "xt" a (k, C, rows, M) one (its two index
// tensors are strided apart, and PyTorch then gathers through contiguous
// copies of them on the card, whose order the gathered rows take), "g" the
// (per, rows, M, M) block of its exponential (per = a.g_block / (rows M^2)
// candidates).  Without elite-carry the chain runs
// every row of the batch in every iteration, so there a row's place is its
// place in the batch: at M >= 128 with M % 4 != 0 the wrapper asks for
// recompute, and every CTA runs the batch's elites through A-C again, their
// results over the carried ones; elsewhere the places give the same bits
// and the carried results stand.

#include <cuda_runtime.h>

#include "inner_cem_body.cuh"

using namespace mmd_cem;

// Floats of device-memory scratch a candidate needs (its state that does
// not fit in shared memory); -1 outside the range the kernel takes.
extern "C" int mmd_inner_cem_scratch(int S, int M, int k, int n_el, int kind, int form,
                                     int recompute) {
  if (!takes(S, M, k, n_el, 1, kind, form)) return -1;
  int most = 0;
  for (int cs : kSizes) {
    const int n =
        cs * make_layout(S, M, k, n_el, kind, cs, form == kFormFused, recompute != 0)
                 .global_floats;
    most = n > most ? n : most;
  }
  return most;
}

// The cluster size (CTAs a candidate) of the last launch.
extern "C" int mmd_inner_cem_last_cluster() { return last_cluster; }

// D, D2 (C, M, M) (D2 null for laplace), samples0 (S, M+1), A_all
// (maxiter, S - n_el, n_el), Zf_all (maxiter, S - n_el, M+1), lane_floor
// (M+1); out beta_w (C, k), sigma_w (C,), idx_best (C, k) int64, res (C,
// maxiter); scratch (C, mmd_inner_cem_scratch(...)) floats.  r_scale: the
// float32 constant r's products take, negated (-rho / M; "xt": -(rho /
// M)); inv_rho: float32(1) / float32(rho).  form: the selection (Form;
// "fused" and "g" laplace only), recompute: the elites run again each
// iteration, g_block: "g"'s floats of a block of its exponential.  Returns
// cudaErrorInvalidValue outside the range the kernel takes (the wrapper
// checks first).
extern "C" int mmd_inner_cem(const float* D, const float* D2, const float* samples0,
                             const float* A_all, const float* Zf_all,
                             const float* lane_floor, float* beta_w, float* sigma_w,
                             long long* idx_best, float* res, float* scratch, int C,
                             int S, int M, int k, int n_el, int maxiter, int kind,
                             float rho, float reg, float r_scale, float inv_rho, int form,
                             int recompute, long long g_block, void* stream) {
  if (C <= 0) return 0;
  if (!takes(S, M, k, n_el, maxiter, kind, form) || (kind != kLaplace && D2 == nullptr) ||
      g_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fused = form == kFormFused;
  const Layout L[3] = {make_layout(S, M, k, n_el, kind, kSizes[0], fused, recompute != 0),
                       make_layout(S, M, k, n_el, kind, kSizes[1], fused, recompute != 0),
                       make_layout(S, M, k, n_el, kind, kSizes[2], fused, recompute != 0)};
  const int slots = slots_of(M);
  const Args a{D,        D2,     samples0, A_all,   Zf_all,  lane_floor, beta_w,
               sigma_w,  res,    scratch,  idx_best, C,      S,          M,
               n_el,     maxiter, kind,    rho,     reg,     r_scale,    inv_rho,
               form,     recompute != 0, g_block};
  const auto s = static_cast<cudaStream_t>(stream);
  return fused ? launch_fused(a, L, C, k, slots, s) : launch_k<false>(a, L, C, k, slots, s);
}
