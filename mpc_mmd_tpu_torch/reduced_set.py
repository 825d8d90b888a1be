"""Reduced-set selection: the batched inner beta-CEM of every candidate.

Counterpart of ``select_reduced_set_batched`` in
``mpc_mmd_tpu/reduced_set.py`` with its production configuration: the
"xla" selection, elite-carry, and the candidate-shared iteration 0.

Per candidate, the (M, M) L1 distance matrix of the mother rollouts'
coefficients is computed once; each inner iteration then picks the top-k
|beta| lanes of every sample (K1), gathers those rows of D, takes
exp(-rows/sigma), and solves the k x k weight QP (K2).  The JAX package
writes these gathers as one-hot einsums to suit the TPU; here they are
direct gathers, which are exact, so the elite rows and every carried value
pass through bit-unchanged (TF32 is off in any case, see ``__init__``).

The inner CEM update is affine in the elites: the fresh rows are
``A_t @ elites + sqrt(jitter) * z_t`` with A_t built from the draws alone,
and the next batch is ``cat(elites, fresh)``, so rows 0..n_el-1 are the
elites by construction.  Their selection and QP results are carried
instead of recomputed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import ProblemConfig
from .kernels import kernel_of, pairwise_l1
from .noise import InnerDraws
from .ops import eq_qp_solve, topk_indices


class ReducedSet(NamedTuple):
    beta: torch.Tensor      # (C, k) weights, slots in descending-|beta| order
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


def select_reduced_set_batched(cfg: ProblemConfig, cx: torch.Tensor,
                               cy: torch.Tensor, x_roll: torch.Tensor,
                               y_roll: torch.Tensor,
                               draws: InnerDraws) -> ReducedSet:
    """Inner CEM over all candidates.

    cx, cy: (C, M, nvar) coefficients of the mother rollouts (the kernel's
    feature space); x_roll, y_roll: (C, M, T).  ``draws`` are the standard
    normals of :class:`mpc_mmd_tpu_torch.noise.InnerDraws`, shared by every
    candidate.
    """
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
    c_ix = torch.arange(C, device=dev)[:, None, None]

    samples0_row = math.sqrt(b.init_cov_scale) * draws.samples0
    samples0_row = torch.cat(
        (samples0_row[:, :M], torch.clamp(samples0_row[:, M:], min=b.sigma_clip)),
        dim=1)

    # affine update coefficients for every iteration (see module docstring)
    inv_sqrt = 1.0 / torch.sqrt(torch.tensor(n_el - 1.0, dtype=dt, device=dev))
    sqrt_jit = torch.sqrt(torch.tensor(b.cov_jitter, dtype=dt, device=dev))
    s_u = torch.sum(draws.u, dim=2)                          # (maxiter, S-n_el)
    A_all = inv_sqrt * draws.u + ((1.0 - inv_sqrt * s_u) / n_el)[..., None]
    Zf_all = sqrt_jit * draws.z                              # (maxiter, S-n_el, M+1)
    lane_floor = torch.full((M + 1,), -torch.inf, dtype=dt, device=dev)
    lane_floor[M] = b.sigma_clip

    def finish(beta, cost):
        # NaN cost -> +inf keeps poisoned samples out of the elites; NaN
        # beta -> 0 as in the JAX package (where a one-hot product needs it)
        cost = torch.where(torch.isnan(cost), torch.full_like(cost, torch.inf), cost)
        beta = torch.where(torch.isnan(beta), torch.zeros_like(beta), beta)
        return beta, cost

    def selection_qp(samples_sub):
        """Selection and weight QP of the rows (C, S', M+1)."""
        sigma = samples_sub[..., M]                          # (C, S')
        idx = topk_indices(samples_sub.contiguous(), k, absolute=True,
                           slice_to=M).long()                # (C, S', k)
        rows = D[c_ix, idx]                                  # (C, S', k, M)
        K_mixed = kernel_of(kind, sigma[..., None, None], rows)
        K_red = torch.gather(K_mixed, 3, idx[:, :, None, :].expand(
            idx.shape[:2] + (k, k)))
        beta, cost = _beta_qp(K_red, K_mixed.sum(dim=-1), M, cfg)
        return (idx,) + finish(beta, cost)

    def update(samples, cost, t):
        """Elites by the top n_el of -cost, then the affine resample."""
        idx_el = topk_indices(-cost, n_el).long()            # (C, n_el)
        elites = _take_rows(samples, idx_el)                 # (C, n_el, M+1)
        fresh = torch.maximum(A_all[t] @ elites + Zf_all[t], lane_floor)
        return (torch.cat((elites, fresh), dim=1), idx_el,
                torch.gather(cost, 1, idx_el))

    # iteration 0: every candidate starts from the same sample rows, so the
    # top-k is computed once and gathered against each candidate's D
    sigma0 = samples0_row[:, M]                              # (S,)
    idx0 = topk_indices(samples0_row[None].contiguous(), k, absolute=True,
                        slice_to=M)[0].long()                # (S, k)
    rows0 = D[:, idx0]                                       # (C, S, k, M)
    K_mixed0 = kernel_of(kind, sigma0[None, :, None, None], rows0)
    K_red0 = torch.gather(K_mixed0, 3, idx0[None, :, None, :].expand(C, S, k, k))
    beta_all, cost = finish(*_beta_qp(K_red0, K_mixed0.sum(dim=-1), M, cfg))
    idx_all = idx0[None].expand(C, S, k)
    samples = samples0_row[None].expand(C, S, M + 1)

    mins = []
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
