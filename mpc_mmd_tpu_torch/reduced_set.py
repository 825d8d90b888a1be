"""Reduced-set selection: the batched inner beta-CEM of every candidate.

Counterpart of ``select_reduced_set_batched`` in
``mpc_mmd_tpu/reduced_set.py`` with its four selections ("xla", "xt",
"fused" and "g"), and of ``select_reduced_set`` under the "exact" strategy
(see :func:`select_reduced_set`).

Per candidate, the (M, M) L1 distance matrix of the mother rollouts'
coefficients is computed once; each inner iteration then runs the
selection stage on every sample and solves the k x k weight QP (K2).  The
"xla" selection picks the top-k |beta| lanes (K1), gathers those rows of D
and takes exp(-rows/sigma); with elite-carry its whole loop is kernel (c)
(``ops.inner_cem``: every iteration of every candidate in one launch,
K1's rounds, the kernel values and K2's solve inside), and its plain
version is that chain.  The "fused" selection does the selection stage in
one kernel (K3).  "xt" is "xla" in the lane-major layout
(reduced_set.py:513-533): the rows are gathered as (k, C, S', M), K_red
straight into (k, k, C S') and row_sum into (k, C S'), the layout of K2's
lane-major entry (``eq_qp_solve_t``), and beta stays (k, C, S') through
the iteration.  "g"
is the reduce-before-gather form (reduced_set.py:497-512): every mother
row's kernel sum for the sample's bandwidth, then the k selected ones
gathered, and K_red from the selected rows' features by pairwise L1; its
(C, S', M, M) exponential is taken in blocks of candidates
(:data:`G_BLOCK_BYTES`).  Under the gaussian and matern52 kernels the
"xla" and "xt" selections also keep the squared L2 distance matrix D2 and
gather its rows beside those of D, and ``kernel_of`` maps the pair to K.
The JAX package writes the gathers as one-hot einsums to suit the TPU;
here they are direct gathers, which are exact, so the elite rows and every
carried value pass through bit-unchanged (TF32 is off in any case, see
``__init__``).

The selection is resolved at call time as in the JAX package
(reduced_set.py:394-406): ``MPC_MMD_SELECTION``, else "fused" when
``MPC_MMD_FUSED_CEM=1``, else "xla".

The inner CEM update is affine in the elites: the fresh rows are
``A_t @ elites + sqrt(jitter) * z_t`` with A_t built from the draws alone,
and the next batch is ``cat(elites, fresh)``, so rows 0..n_el-1 are the
elites by construction.  Their selection and QP results are carried
instead of recomputed (elite-carry, with a candidate-shared iteration 0
under "xla" and "xt").  The "fused" selection, and the others with
``MPC_MMD_ELITE_CARRY=0``, run the full-recompute loop instead: every row
in every iteration, from the broadcast (C, S, M+1) batch at iteration 0
(reduced_set.py:721-740).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import ProblemConfig
from .kernels import distance_matrices, kernel_of
from .noise import ExactInnerDraws, InnerDraws
from .ops import eq_qp_solve_t, inner_cem, topk_indices, topk_kernel_matrices
from .ops.inner_cem import beta_qp, finish, resample, selection_qp_xla, take_rows

SELECTIONS = ("xla", "xt", "fused", "g")

# Bytes of "g"'s exponential temporary (candidates, S', M, M) per block of
# candidates: at the dynamic workload's width (100 x 100 x 100 x 100) one
# call would otherwise hold 400 MB.
G_BLOCK_BYTES = 64 * 2 ** 20


class ReducedSet(NamedTuple):
    beta: torch.Tensor      # (C, k) weights; slots in descending-|beta| order
    #                       # on the fast path, ascending under "exact"
    sigma: torch.Tensor     # (C,) bandwidth, from the post-update batch
    x_red: torch.Tensor     # (C, k, T) reduced rollouts
    y_red: torch.Tensor
    res: torch.Tensor       # (C, maxiter) best MMD residual per iteration


def _beta_qp_t(K_red_t: torch.Tensor, row_sum_t: torch.Tensor, M: int,
               cfg: ProblemConfig):
    """``ops.inner_cem.beta_qp`` in the lane-major layout
    (reduced_set.py:108-139): K_red_t (k, k, B), row_sum_t (k, B); returns
    (beta_t (k, B), mmd (B,)), the QP through K2's lane-major entry."""
    b = cfg.beta_cem
    k, B = K_red_t.shape[0], K_red_t.shape[-1]
    eye_flat = torch.eye(k, dtype=K_red_t.dtype, device=K_red_t.device).reshape(k * k, 1)
    cost_t = b.rho_beta * K_red_t.reshape(k * k, B) + b.qp_reg * eye_flat
    r_t = (b.rho_beta / M) * row_sum_t
    beta_t, mu = eq_qp_solve_t(cost_t, r_t.contiguous())
    br = torch.sum(beta_t * r_t, dim=0)
    mmd = (-br - mu - b.qp_reg * torch.sum(beta_t * beta_t, dim=0)) / b.rho_beta
    return beta_t, mmd


def resolve_selection(cfg: ProblemConfig, selection: Optional[str] = None) -> str:
    """The selection a call runs: the argument, else ``MPC_MMD_SELECTION``,
    else "fused" if ``MPC_MMD_FUSED_CEM=1`` (never under the exact
    strategy), else "xla"; as the JAX package resolves it.

    Under a kernel other than laplace, "fused" and "g" become "xla": both
    hard-code the Laplace exp, and the JAX package applies the same rule
    (reduced_set.py:402-406).  The gaussian and matern52 selections run
    as the laplace ones do ("xla": kernel (c); "xt": K1 and the lane-major
    K2).
    """
    if selection is None:
        fused = (cfg.solve_strategy != "exact"
                 and os.environ.get("MPC_MMD_FUSED_CEM") == "1")
        selection = os.environ.get("MPC_MMD_SELECTION") or (
            "fused" if fused else "xla")
    if cfg.risk.kernel != "laplace" and selection in ("fused", "g"):
        selection = "xla"
    if selection not in SELECTIONS:
        raise ValueError(f"unknown selection {selection!r} "
                         "(expected 'xla', 'xt', 'fused' or 'g')")
    return selection


def selection_key(cfg: ProblemConfig, selection: Optional[str] = None
                  ) -> Tuple[str, bool]:
    """(selection, elite-carry) of a call now (:func:`resolve_selection`;
    elite-carry unless "fused" or ``MPC_MMD_ELITE_CARRY=0``): what a solve
    captured in a CUDA graph keeps, so a graph is keyed by it."""
    selection = resolve_selection(cfg, selection)
    return selection, (selection != "fused"
                       and os.environ.get("MPC_MMD_ELITE_CARRY", "1") != "0")


class InnerFixed(NamedTuple):
    """What the batched inner CEM's loop takes from the solver-fixed draws
    alone (see :func:`inner_fixed`)."""
    samples0_row: torch.Tensor    # (S, M+1) the first batch, sigma clipped
    A_all: torch.Tensor           # (maxiter, S - n_el, n_el)
    Zf_all: torch.Tensor          # (maxiter, S - n_el, M+1)
    lane_floor: torch.Tensor      # (M+1,) -inf, then sigma_clip


class InnerInputs(NamedTuple):
    """What the batched inner CEM's loop starts from (see
    :func:`inner_inputs`)."""
    D: torch.Tensor               # (C, M, M) L1 distances of the mother rollouts
    D2: Optional[torch.Tensor]    # (C, M, M) squared L2 ones, or None (laplace)
    samples0_row: torch.Tensor
    A_all: torch.Tensor
    Zf_all: torch.Tensor
    lane_floor: torch.Tensor


def inner_fixed(cfg: ProblemConfig, draws: InnerDraws) -> InnerFixed:
    """The first batch and the affine resample's coefficients from the
    draws: the same in every outer iteration, so a solver computes them
    once beside its solver-fixed draws (``SolverSetup._inner_fixed``)."""
    b = cfg.beta_cem
    M, n_el = cfg.risk.num_mother, b.num_ellite
    samples0_row = math.sqrt(b.init_cov_scale) * draws.samples0
    dev, dt = samples0_row.device, samples0_row.dtype
    samples0_row = torch.cat(
        (samples0_row[:, :M], torch.clamp(samples0_row[:, M:], min=b.sigma_clip)),
        dim=1)

    # affine update coefficients for every iteration (see module docstring),
    # with the JAX package's float32 constants as Python floats (a tensor
    # made on the card from the host would be a blocking copy)
    inv_sqrt = float(np.float32(1.0) / np.sqrt(np.float32(n_el - 1.0)))
    sqrt_jit = float(np.sqrt(np.float32(b.cov_jitter)))
    s_u = torch.sum(draws.u, dim=2)                          # (maxiter, S-n_el)
    A_all = inv_sqrt * draws.u + ((1.0 - inv_sqrt * s_u) / n_el)[..., None]
    Zf_all = sqrt_jit * draws.z                              # (maxiter, S-n_el, M+1)
    # (built on the card: an indexed store of a host scalar synchronises)
    lane_floor = torch.cat((torch.full((M,), -torch.inf, dtype=dt, device=dev),
                            torch.full((1,), b.sigma_clip, dtype=dt, device=dev)))
    return InnerFixed(samples0_row, A_all, Zf_all, lane_floor)


def inner_inputs(cfg: ProblemConfig, cx: torch.Tensor, cy: torch.Tensor,
                 draws: InnerDraws) -> InnerInputs:
    """The step before the inner CEM's loop: the distance matrices of the
    mother rollouts' coefficients cx, cy (C, M, nvar) and
    :func:`inner_fixed` of the draws."""
    return InnerInputs(*distance_matrices(cx, cy, cfg.risk.kernel),
                       *inner_fixed(cfg, draws))


def select_reduced_set_batched(cfg: ProblemConfig, cx: torch.Tensor,
                               cy: torch.Tensor, x_roll: torch.Tensor,
                               y_roll: torch.Tensor, draws: InnerDraws,
                               selection: Optional[str] = None,
                               distances: Optional[Tuple] = None,
                               fixed: Optional[InnerFixed] = None) -> ReducedSet:
    """Inner CEM over all candidates.

    cx, cy: (C, M, nvar) coefficients of the mother rollouts (the kernel's
    feature space); x_roll, y_roll: (C, M, T).  ``draws`` are the standard
    normals of :class:`mpc_mmd_tpu_torch.noise.InnerDraws`, shared by every
    candidate.  ``selection``: see :func:`resolve_selection`.
    ``distances``: (D, D2) of cx, cy as ``kernels.distance_matrices``
    gives them (kernel (f)'s, ``ops.inner_prologue``), else computed here;
    ``fixed``: :func:`inner_fixed` of the draws, else computed here.
    """
    selection, elite_carry = selection_key(cfg, selection)
    b = cfg.beta_cem
    M = cfg.risk.num_mother
    k = cfg.risk.num_reduced
    S = b.num_samples_cem
    n_el = b.num_ellite
    kind = cfg.risk.kernel
    C = cx.shape[0]
    dev = cx.device

    D, D2 = distances if distances is not None else distance_matrices(cx, cy, kind)
    samples0_row, A_all, Zf_all, lane_floor = (fixed if fixed is not None
                                               else inner_fixed(cfg, draws))
    c_ix = torch.arange(C, device=dev)[:, None, None]

    if (selection, elite_carry) == ("xla", True):
        beta_w, sigma_w, idx_best, res = inner_cem(
            D, D2, samples0_row, A_all, Zf_all, lane_floor, k, n_el, b.rho_beta,
            b.qp_reg, kind)
        return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=take_rows(x_roll, idx_best),
                          y_red=take_rows(y_roll, idx_best), res=res)

    # "xt" keeps beta lane-major, (k, C, rows): its row axis is the last
    lane_major = selection == "xt"
    b_axis = 2 if lane_major else 1

    def take_beta(beta, idx):
        """beta's rows idx (C, n), in beta's layout."""
        if lane_major:
            return torch.gather(beta, 2, idx[None].expand(k, -1, -1))
        return take_rows(beta, idx)

    def lane_major_qp(idx_t, sigma):
        """The "xt" stage from the top-k lanes idx_t (k, C', S') and the
        bandwidths sigma (C', S'): K_mixed as (k, C', S', M), K_red_t[i, j]
        = K_mixed[i, ..., idx_t[j]], the QP lane-major.  Returns beta
        (k, C', S') and cost (C', S')."""
        c_ix_t = torch.arange(idx_t.shape[1], device=dev)[None, :, None]
        rows = D[c_ix_t, idx_t]                              # (k, C', S', M)
        rows2 = None if D2 is None else D2[c_ix_t, idx_t]
        K_mixed = kernel_of(kind, sigma[None, :, :, None], rows, rows2)
        K_red_t = torch.gather(K_mixed.permute(0, 3, 1, 2), 1,
                               idx_t[None].expand(k, -1, -1, -1))  # (k, k, C', S')
        Cc, Ss = sigma.shape
        beta_t, cost = _beta_qp_t(K_red_t.reshape(k, k, Cc * Ss),
                                  K_mixed.sum(dim=-1).reshape(k, Cc * Ss), M, cfg)
        return beta_t.reshape(k, Cc, Ss), cost.reshape(Cc, Ss)

    def row_kernel_sums(sigma):
        """G (C, S', M): G[c, s, r] = sum_m exp(-D[c, r, m] / sigma[c, s]),
        the exponential taken a block of candidates at a time."""
        S_sub = sigma.shape[1]
        per = max(1, G_BLOCK_BYTES // (4 * S_sub * M * M))
        return torch.cat([
            torch.exp(-D[lo:lo + per, None] / sigma[lo:lo + per, :, None, None]).sum(-1)
            for lo in range(0, C, per)])

    def selection_qp(samples_sub):
        """Selection and weight QP of the rows (C, S', M+1)."""
        if selection == "xla":
            return selection_qp_xla(samples_sub, D, D2, k, kind, b.rho_beta, b.qp_reg)
        if selection == "fused":
            row_sum, K_red, idx = topk_kernel_matrices(samples_sub, D, k)
            idx = idx.long()
        else:
            sigma = samples_sub[..., M]                      # (C, S')
            idx = topk_indices(samples_sub.contiguous(), k, absolute=True,
                               slice_to=M).long()            # (C, S', k)
            if selection == "xt":
                return (idx,) + finish(*lane_major_qp(idx.permute(2, 0, 1), sigma))
            row_sum = torch.gather(row_kernel_sums(sigma), 2, idx)   # "g"
            feats = torch.cat((cx, cy), dim=2)
            fsel = feats[c_ix, idx]                          # (C, S', k, F)
            d_sub = torch.sum(torch.abs(fsel[:, :, :, None, :]
                                        - fsel[:, :, None, :, :]), dim=-1)
            K_red = torch.exp(-d_sub / sigma[..., None, None])
        beta, cost = beta_qp(K_red, row_sum, M, b.rho_beta, b.qp_reg)
        return (idx,) + finish(beta, cost)

    samples = samples0_row[None].expand(C, S, M + 1)
    mins = []
    if elite_carry:
        if selection == "g":
            idx_all, beta_all, cost = selection_qp(samples)
        else:
            # iteration 0 of "xt": every candidate starts from the same
            # sample rows, so the top-k is computed once and gathered
            # against each candidate's D
            sigma0 = samples0_row[:, M]                      # (S,)
            idx0 = topk_indices(samples0_row[None].contiguous(), k, absolute=True,
                                slice_to=M)[0].long()        # (S, k)
            beta_all, cost = finish(*lane_major_qp(
                idx0.T[:, None].expand(k, C, S), sigma0.expand(C, S)))
            idx_all = idx0[None].expand(C, S, k)
        for t in range(b.maxiter):
            if t > 0:
                idx_f, beta_f, cost_f = selection_qp(samples[:, n_el:])
                idx_all = torch.cat((el_idx, idx_f), dim=1)
                beta_all = torch.cat((el_beta, beta_f), dim=b_axis)
                cost = torch.cat((el_cost, cost_f), dim=1)
            samples, idx_el, el_cost = resample(samples, cost, A_all[t], Zf_all[t],
                                                lane_floor, n_el)
            el_idx = take_rows(idx_all, idx_el)
            el_beta = take_beta(beta_all, idx_el)
            mins.append(cost.min(dim=1).values)
    else:
        # full recompute; iteration 0 runs on the broadcast batch (K3 takes
        # its candidate stride of 0, the top-k a copy)
        for t in range(b.maxiter):
            idx_all, beta_all, cost = selection_qp(samples)
            samples = resample(samples, cost, A_all[t], Zf_all[t], lane_floor, n_el)[0]
            mins.append(cost.min(dim=1).values)

    # winner of the last iteration; sigma from the post-update batch (the
    # reference's quirk)
    i_min = torch.argmin(cost, dim=1, keepdim=True)          # (C, 1)
    beta_w = take_beta(beta_all, i_min)
    beta_w = beta_w[..., 0].T.contiguous() if lane_major else beta_w[:, 0]
    sigma_w = torch.gather(samples[..., M], 1, i_min)[:, 0]
    idx_best = take_rows(idx_all, i_min)[:, 0]              # (C, k)
    x_red = take_rows(x_roll, idx_best)
    y_red = take_rows(y_roll, idx_best)
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=x_red, y_red=y_red,
                      res=torch.stack(mins, dim=1))


def _beta_qp_exact(K_red: torch.Tensor, row_sum: torch.Tensor, M: int,
                   cfg: ProblemConfig):
    """The weight QP of ``ops.inner_cem.beta_qp`` as the reference solves it: the
    bordered KKT system [[rho K_red + reg I, 1], [1^T, 0]] densely by LU
    (``solve_ex``: no device synchronisation; a singular system gives inf
    or NaN), and the mmd cost b'K_red b + q.b with q = -2/M row_sum."""
    b = cfg.beta_cem
    k = K_red.shape[-1]
    eye = torch.eye(k, dtype=K_red.dtype, device=K_red.device)
    cost = b.rho_beta * K_red + b.qp_reg * eye
    lincost = -b.rho_beta * (1.0 / M) * row_sum
    kkt = torch.zeros(K_red.shape[:-2] + (k + 1, k + 1), dtype=K_red.dtype,
                      device=K_red.device)
    kkt[..., :k, :k] = cost
    kkt[..., :k, k] = 1.0
    kkt[..., k, :k] = 1.0
    rhs = torch.cat((-lincost, torch.ones_like(lincost[..., :1])), dim=-1)
    sol = torch.linalg.solve_ex(kkt, rhs[..., None], check_errors=False).result
    beta = sol[..., :k, 0]
    q = -2.0 * (1.0 / M) * row_sum
    mmd = (torch.einsum("...i,...ij,...j->...", beta, K_red, beta)
           + torch.sum(q * beta, dim=-1))
    return beta, mmd


def _cov_ddof1(X: torch.Tensor) -> torch.Tensor:
    """np.cov of the rows of X (..., n, d) with ddof 1, as (..., d, d)."""
    Xc = X - torch.mean(X, dim=-2, keepdim=True)
    return (Xc.mT @ Xc) / (X.shape[-2] - 1)


def select_reduced_set(cfg: ProblemConfig, cx: torch.Tensor, cy: torch.Tensor,
                       x_roll: torch.Tensor, y_roll: torch.Tensor,
                       draws: ExactInnerDraws) -> ReducedSet:
    """The reference-parity inner CEM (the "exact" strategy) of every
    candidate: the JAX ``vmap`` of ``select_reduced_set``
    (reduced_set.py:195-336).  Arguments as
    :func:`select_reduced_set_batched`; ``draws`` are the standard normals
    of :class:`mpc_mmd_tpu_torch.noise.ExactInnerDraws`, shared by every
    candidate.

    Per iteration: the top k of |beta| as the last k of a stable argsort
    (slots in ascending |beta|), direct gathers of the D rows and their
    columns, the dense weight QP, elites by a stable argsort of the cost,
    and the resample from N(mean, cov(elites, ddof 1) + jitter I) as
    ``mean + z @ chol(cov)^T`` (a covariance that is not positive definite
    gives NaN, as in JAX), with sigma clipped on every row.  Nothing
    synchronises with the device.
    """
    b = cfg.beta_cem
    M, k = cfg.risk.num_mother, cfg.risk.num_reduced
    S, n_el = b.num_samples_cem, b.num_ellite
    kind = cfg.risk.kernel
    C = cx.shape[0]
    dev, dt = cx.device, cx.dtype

    D, D2 = distance_matrices(cx, cy, kind)                 # (C, M, M)
    c_ix = torch.arange(C, device=dev)
    eye = torch.eye(M + 1, dtype=dt, device=dev)

    # N(0, init_cov_scale I) from the prefactored path's own draw
    samples = math.sqrt(b.init_cov_scale) * draws.samples0
    samples = torch.cat((samples[:, :M], torch.clamp(samples[:, M:], min=b.sigma_clip)),
                        dim=1)[None].expand(C, S, M + 1)
    mins = []
    for t in range(b.maxiter):
        sigma = samples[..., M, None, None]                  # (C, S, 1, 1)
        idx_top = torch.argsort(torch.abs(samples[..., :M]), dim=-1,
                                stable=True)[..., M - k:]    # (C, S, k)
        rows = D[c_ix[:, None, None], idx_top]               # (C, S, k, M)
        cols = idx_top[:, :, None, :].expand(C, S, k, k)
        if kind == "laplace":
            K_mixed = torch.exp(-rows / sigma)
            K_red = torch.exp(-torch.take_along_dim(rows, cols, dim=3) / sigma)
        else:
            K_mixed = kernel_of(kind, sigma, rows, D2[c_ix[:, None, None], idx_top])
            K_red = torch.take_along_dim(K_mixed, cols, dim=3)
        beta, cost = _beta_qp_exact(K_red, K_mixed.sum(dim=-1), M, cfg)

        elites = take_rows(samples, torch.argsort(cost, dim=1, stable=True)[:, :n_el])
        mean = torch.mean(elites, dim=1)                     # (C, M+1)
        factor, info = torch.linalg.cholesky_ex(_cov_ddof1(elites) + b.cov_jitter * eye)
        factor = torch.where((info == 0)[:, None, None], factor,
                             torch.full_like(factor, torch.nan))
        fresh = mean[:, None, :] + draws.z[t] @ factor.mT    # (C, S-n_el, M+1)
        samples = torch.cat((elites, fresh), dim=1)
        samples = torch.cat((samples[..., :M],
                             torch.clamp(samples[..., M:], min=b.sigma_clip)), dim=-1)

        # the winner; sigma from the post-update batch (the reference's quirk)
        i_min = torch.argmin(cost, dim=1)
        beta_w, sigma_w = beta[c_ix, i_min], samples[c_ix, i_min, M]
        idx_w = idx_top[c_ix, i_min]                         # (C, k)
        mins.append(cost.min(dim=1).values)
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=take_rows(x_roll, idx_w),
                      y_red=take_rows(y_roll, idx_w), res=torch.stack(mins, dim=1))
