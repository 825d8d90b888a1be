"""Reduced-set selection: the batched inner beta-CEM of every candidate.

Counterpart of ``select_reduced_set_batched`` in
``mpc_mmd_tpu/reduced_set.py`` with its "xla" and "fused" selections, and
of ``select_reduced_set`` under the "exact" strategy (see
:func:`select_reduced_set`).

Per candidate, the (M, M) L1 distance matrix of the mother rollouts'
coefficients is computed once; each inner iteration then runs the
selection stage on every sample and solves the k x k weight QP (K2).  The
"xla" selection picks the top-k |beta| lanes (K1), gathers those rows of D
and takes exp(-rows/sigma); the "fused" one does all of that in one kernel
(K3).  Under the gaussian and matern52 kernels the "xla" selection also
keeps the squared L2 distance matrix D2 and gathers its rows beside those
of D, and ``kernel_of`` maps the pair to K.  The JAX package writes the
gathers as one-hot einsums to suit the TPU; here they are direct gathers,
which are exact, so the elite rows and every carried value pass through
bit-unchanged (TF32 is off in any case, see ``__init__``).

The selection is resolved at call time as in the JAX package
(reduced_set.py:394-406): ``MPC_MMD_SELECTION``, else "fused" when
``MPC_MMD_FUSED_CEM=1``, else "xla".  The JAX package's "xt" and "g"
selections are not ported (ROADMAP.md, "Not to port").

The inner CEM update is affine in the elites: the fresh rows are
``A_t @ elites + sqrt(jitter) * z_t`` with A_t built from the draws alone,
and the next batch is ``cat(elites, fresh)``, so rows 0..n_el-1 are the
elites by construction.  Their selection and QP results are carried
instead of recomputed (elite-carry, with a candidate-shared iteration 0).
The "fused" selection, and "xla" with ``MPC_MMD_ELITE_CARRY=0``, run the
full-recompute loop instead: every row in every iteration, from the
broadcast (C, S, M+1) batch at iteration 0 (reduced_set.py:721-740).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import ProblemConfig
from .kernels import kernel_of, pairwise_l1, pairwise_l2sq
from .noise import ExactInnerDraws, InnerDraws
from .ops import eq_qp_solve, topk_indices, topk_kernel_matrices

SELECTIONS = ("xla", "fused")


class ReducedSet(NamedTuple):
    beta: torch.Tensor      # (C, k) weights; slots in descending-|beta| order
    #                       # on the fast path, ascending under "exact"
    sigma: torch.Tensor     # (C,) bandwidth, from the post-update batch
    x_red: torch.Tensor     # (C, k, T) reduced rollouts
    y_red: torch.Tensor
    res: torch.Tensor       # (C, maxiter) best MMD residual per iteration


def _beta_qp(K_red: torch.Tensor, row_sum: torch.Tensor, M: int,
             cfg: ProblemConfig):
    """Weight QP  min rho b'K_red b - 2 rho/M row_sum.b  s.t. sum(b) = 1.

    K_red (..., k, k), row_sum (..., k).  Returns (beta (..., k), mmd (...)),
    with the mmd cost in closed form from the KKT identity
    (rho K_red + reg I) b = r - mu 1:  mmd = (-b.r - mu - reg |b|^2) / rho.
    """
    b = cfg.beta_cem
    k = K_red.shape[-1]
    eye = torch.eye(k, dtype=K_red.dtype, device=K_red.device)
    cost = b.rho_beta * K_red + b.qp_reg * eye
    lincost = -b.rho_beta * (1.0 / M) * row_sum
    r = -lincost
    beta, mu = eq_qp_solve(cost.contiguous(), r.contiguous())
    br = torch.sum(beta * r, dim=-1)
    mmd = (-br - mu - b.qp_reg * torch.sum(beta * beta, dim=-1)) / b.rho_beta
    return beta, mmd


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (C, S, ...) indexed along axis 1 by idx (C, n) -> (C, n, ...)."""
    view = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, view.expand(idx.shape + t.shape[2:]))


def resolve_selection(cfg: ProblemConfig, selection: Optional[str] = None) -> str:
    """The selection a call runs: the argument, else ``MPC_MMD_SELECTION``,
    else "fused" if ``MPC_MMD_FUSED_CEM=1`` (never under the exact
    strategy), else "xla"; as the JAX package resolves it.

    Under a kernel other than laplace, "fused" (and "g") become "xla": K3
    hard-codes the Laplace exp, and the JAX package applies the same rule
    (reduced_set.py:402-406).  The gaussian and matern52 selections run
    K1 and K2 as the laplace "xla" one does.
    """
    if selection is None:
        fused = (cfg.solve_strategy != "exact"
                 and os.environ.get("MPC_MMD_FUSED_CEM") == "1")
        selection = os.environ.get("MPC_MMD_SELECTION") or (
            "fused" if fused else "xla")
    if cfg.risk.kernel != "laplace" and selection in ("fused", "g"):
        selection = "xla"
    if selection in ("xt", "g"):
        raise NotImplementedError(
            f"selection {selection!r} is not ported: it exists only to suit "
            "the TPU (ROADMAP.md, 'Not to port')")
    if selection not in SELECTIONS:
        raise ValueError(f"unknown selection {selection!r} "
                         "(expected 'xla', 'xt', 'fused' or 'g')")
    return selection


def select_reduced_set_batched(cfg: ProblemConfig, cx: torch.Tensor,
                               cy: torch.Tensor, x_roll: torch.Tensor,
                               y_roll: torch.Tensor, draws: InnerDraws,
                               selection: Optional[str] = None) -> ReducedSet:
    """Inner CEM over all candidates.

    cx, cy: (C, M, nvar) coefficients of the mother rollouts (the kernel's
    feature space); x_roll, y_roll: (C, M, T).  ``draws`` are the standard
    normals of :class:`mpc_mmd_tpu_torch.noise.InnerDraws`, shared by every
    candidate.  ``selection``: see :func:`resolve_selection`.
    """
    selection = resolve_selection(cfg, selection)
    elite_carry = (selection != "fused"
                   and os.environ.get("MPC_MMD_ELITE_CARRY", "1") != "0")
    b = cfg.beta_cem
    M = cfg.risk.num_mother
    k = cfg.risk.num_reduced
    S = b.num_samples_cem
    n_el = b.num_ellite
    kind = cfg.risk.kernel
    C = cx.shape[0]
    dev, dt = cx.device, cx.dtype

    feats = torch.cat((cx, cy), dim=2)                       # (C, M, 2 nvar)
    D = pairwise_l1(feats, feats)                            # (C, M, M)
    # squared L2 distances only for the kernels that read them
    D2 = pairwise_l2sq(feats, feats) if kind != "laplace" else None
    c_ix = torch.arange(C, device=dev)[:, None, None]

    samples0_row = math.sqrt(b.init_cov_scale) * draws.samples0
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

    def finish(beta, cost):
        # NaN cost -> +inf keeps poisoned samples out of the elites; NaN
        # beta -> 0 as in the JAX package (where a one-hot product needs it)
        cost = torch.where(torch.isnan(cost), torch.full_like(cost, torch.inf), cost)
        beta = torch.where(torch.isnan(beta), torch.zeros_like(beta), beta)
        return beta, cost

    def selection_qp(samples_sub):
        """Selection and weight QP of the rows (C, S', M+1)."""
        if selection == "fused":
            row_sum, K_red, idx = topk_kernel_matrices(samples_sub, D, k)
            idx = idx.long()
        else:
            sigma = samples_sub[..., M]                      # (C, S')
            idx = topk_indices(samples_sub.contiguous(), k, absolute=True,
                               slice_to=M).long()            # (C, S', k)
            rows = D[c_ix, idx]                              # (C, S', k, M)
            rows2 = None if D2 is None else D2[c_ix, idx]
            K_mixed = kernel_of(kind, sigma[..., None, None], rows, rows2)
            K_red = torch.gather(K_mixed, 3, idx[:, :, None, :].expand(
                idx.shape[:2] + (k, k)))
            row_sum = K_mixed.sum(dim=-1)
        beta, cost = _beta_qp(K_red, row_sum, M, cfg)
        return (idx,) + finish(beta, cost)

    def update(samples, cost, t):
        """Elites by the top n_el of -cost, then the affine resample."""
        idx_el = topk_indices(-cost, n_el).long()            # (C, n_el)
        elites = _take_rows(samples, idx_el)                 # (C, n_el, M+1)
        fresh = torch.maximum(A_all[t] @ elites + Zf_all[t], lane_floor)
        return (torch.cat((elites, fresh), dim=1), idx_el,
                torch.gather(cost, 1, idx_el))

    samples = samples0_row[None].expand(C, S, M + 1)
    mins = []
    if elite_carry:
        # iteration 0: every candidate starts from the same sample rows, so
        # the top-k is computed once and gathered against each candidate's D
        sigma0 = samples0_row[:, M]                          # (S,)
        idx0 = topk_indices(samples0_row[None].contiguous(), k, absolute=True,
                            slice_to=M)[0].long()            # (S, k)
        rows0 = D[:, idx0]                                   # (C, S, k, M)
        rows0_2 = None if D2 is None else D2[:, idx0]
        K_mixed0 = kernel_of(kind, sigma0[None, :, None, None], rows0, rows0_2)
        K_red0 = torch.gather(K_mixed0, 3,
                              idx0[None, :, None, :].expand(C, S, k, k))
        beta_all, cost = finish(*_beta_qp(K_red0, K_mixed0.sum(dim=-1), M, cfg))
        idx_all = idx0[None].expand(C, S, k)
        for t in range(b.maxiter):
            if t > 0:
                idx_f, beta_f, cost_f = selection_qp(samples[:, n_el:])
                idx_all = torch.cat((el_idx, idx_f), dim=1)
                beta_all = torch.cat((el_beta, beta_f), dim=1)
                cost = torch.cat((el_cost, cost_f), dim=1)
            samples, idx_el, el_cost = update(samples, cost, t)
            el_idx = _take_rows(idx_all, idx_el)
            el_beta = _take_rows(beta_all, idx_el)
            mins.append(cost.min(dim=1).values)
    else:
        # full recompute; iteration 0 runs on the broadcast batch (K3 takes
        # its candidate stride of 0, the "xla" top-k a copy)
        for t in range(b.maxiter):
            idx_all, beta_all, cost = selection_qp(samples)
            samples = update(samples, cost, t)[0]
            mins.append(cost.min(dim=1).values)

    # winner of the last iteration; sigma from the post-update batch (the
    # reference's quirk)
    i_min = torch.argmin(cost, dim=1, keepdim=True)          # (C, 1)
    beta_w = _take_rows(beta_all, i_min)[:, 0]
    sigma_w = torch.gather(samples[..., M], 1, i_min)[:, 0]
    idx_best = _take_rows(idx_all, i_min)[:, 0]              # (C, k)
    x_red = _take_rows(x_roll, idx_best)
    y_red = _take_rows(y_roll, idx_best)
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=x_red, y_red=y_red,
                      res=torch.stack(mins, dim=1))


def _beta_qp_exact(K_red: torch.Tensor, row_sum: torch.Tensor, M: int,
                   cfg: ProblemConfig):
    """The weight QP of :func:`_beta_qp` as the reference solves it: the
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

    feats = torch.cat((cx, cy), dim=2)
    D = pairwise_l1(feats, feats)                            # (C, M, M)
    D2 = pairwise_l2sq(feats, feats) if kind != "laplace" else None
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

        elites = _take_rows(samples, torch.argsort(cost, dim=1, stable=True)[:, :n_el])
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
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=_take_rows(x_roll, idx_w),
                      y_red=_take_rows(y_roll, idx_w), res=torch.stack(mins, dim=1))
