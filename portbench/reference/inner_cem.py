# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/inner_cem.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""Kernel (c)'s plain version: the inner beta-CEM of every candidate under
the "xla" selection with elite-carry, the pair the cells' configurations
run (the port's default), as ``select_reduced_set_batched`` ran it before
kernel (c) took the pair.

The JAX package runs the inner CEM as one ``lax.scan``
(``mpc_mmd_tpu/reduced_set.py:622-717``) with its "xla" selection
(``reduced_set.py:395-406``) inside: a top-k, gathers of D's rows and the
kernel values, the weight QP, the elite pick and a batched product for the
resample.  The other selections ("xt", "fused", "g") and the chain without
elite-carry are the port's; copy them here with a cell that runs them.

The inputs are the step before the loop: the (C, M, M) L1 distance matrix
D of every candidate's mother rollouts, the clipped first batch
``samples0_row`` (S, M+1) that every candidate starts from, the affine
resample's coefficients ``A_all`` (maxiter, S - n_el, n_el) and
``Zf_all`` (maxiter, S - n_el, M+1) and the lane floor (M+1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernels import kernel_of
from .linalg import eq_qp_solve
from .topk import topk_indices

InnerResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t (C, S, ...) indexed along axis 1 by idx (C, n) -> (C, n, ...)."""
    view = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, view.expand(idx.shape + t.shape[2:]))


def beta_qp(K_red: torch.Tensor, row_sum: torch.Tensor, M: int, rho: float,
            reg: float):
    """Weight QP  min rho b'K_red b - 2 rho/M row_sum.b  s.t. sum(b) = 1.

    K_red (..., k, k), row_sum (..., k).  Returns (beta (..., k), mmd (...)),
    with the mmd cost in closed form from the KKT identity
    (rho K_red + reg I) b = r - mu 1:  mmd = (-b.r - mu - reg |b|^2) / rho.
    """
    k = K_red.shape[-1]
    eye = torch.eye(k, dtype=K_red.dtype, device=K_red.device)
    cost = rho * K_red + reg * eye
    lincost = -rho * (1.0 / M) * row_sum
    r = -lincost
    beta, mu = eq_qp_solve(cost.contiguous(), r.contiguous())
    br = torch.sum(beta * r, dim=-1)
    mmd = (-br - mu - reg * torch.sum(beta * beta, dim=-1)) / rho
    return beta, mmd


def finish(beta: torch.Tensor, cost: torch.Tensor):
    """NaN cost -> +inf keeps poisoned samples out of the elites; NaN beta
    -> 0 as in the JAX package (where a one-hot product needs it)."""
    cost = torch.where(torch.isnan(cost), torch.full_like(cost, torch.inf), cost)
    beta = torch.where(torch.isnan(beta), torch.zeros_like(beta), beta)
    return beta, cost


def selection_qp_xla(samples_sub: torch.Tensor, D: torch.Tensor,
                     D2: Optional[torch.Tensor], k: int, kind: str, rho: float,
                     reg: float):
    """The "xla" selection and weight QP of the rows (C, S', M+1): the
    top-k |beta| lanes (K1), their D rows gathered, K_mixed =
    kernel(rows, sigma), K_red gathered from it, the QP (K2).  Returns
    (idx (C, S', k) int64, beta (C, S', k), cost (C, S'))."""
    M = D.shape[-1]
    c_ix = torch.arange(D.shape[0], device=D.device)[:, None, None]
    sigma = samples_sub[..., M]                              # (C, S')
    idx = topk_indices(samples_sub.contiguous(), k, absolute=True,
                       slice_to=M).long()                    # (C, S', k)
    rows = D[c_ix, idx]                                      # (C, S', k, M)
    rows2 = None if D2 is None else D2[c_ix, idx]
    K_mixed = kernel_of(kind, sigma[..., None, None], rows, rows2)
    K_red = torch.gather(K_mixed, 3, idx[:, :, None, :].expand(
        idx.shape[:2] + (k, k)))
    beta, cost = beta_qp(K_red, K_mixed.sum(dim=-1), M, rho, reg)
    return (idx,) + finish(beta, cost)


def resample(samples: torch.Tensor, cost: torch.Tensor, A_t: torch.Tensor,
             Zf_t: torch.Tensor, lane_floor: torch.Tensor, n_el: int):
    """Elites by the top n_el of -cost (K1), then the affine resample:
    returns (cat(elites, max(A_t @ elites + Zf_t, lane_floor)), the elites'
    indices (C, n_el), their costs)."""
    idx_el = topk_indices(-cost, n_el).long()                # (C, n_el)
    elites = take_rows(samples, idx_el)                      # (C, n_el, M+1)
    fresh = torch.maximum(A_t @ elites + Zf_t, lane_floor)
    return (torch.cat((elites, fresh), dim=1), idx_el,
            torch.gather(cost, 1, idx_el))


def inner_cem(D: torch.Tensor, D2: Optional[torch.Tensor],
              samples0_row: torch.Tensor, A_all: torch.Tensor,
              Zf_all: torch.Tensor, lane_floor: torch.Tensor, k: int, n_el: int,
              rho: float, reg: float, kind: str) -> InnerResult:
    """The inner beta-CEM of every candidate, all ``A_all.shape[0]``
    iterations, under the "xla" selection with elite-carry.

    D (C, M, M) (D2 None under the laplace kernel); samples0_row (S, M+1);
    A_all (maxiter, S - n_el, n_el); Zf_all (maxiter, S - n_el, M+1);
    lane_floor (M+1); k = num_reduced, n_el the elites, rho and reg the
    weight QP's ``rho_beta`` and ``qp_reg``.  Returns (beta_w (C, k),
    sigma_w (C,), idx_best (C, k) int64, res (C, maxiter)): the winner's
    weights, bandwidth (from the post-update batch) and mother-rollout
    indices, and each iteration's least cost.  Iteration 0: every
    candidate starts from the same sample rows, so the top-k is computed
    once and gathered against each candidate's D; later iterations carry
    the elites' selection and QP results and run the fresh rows."""
    C, M = D.shape[0], D.shape[-1]
    S = samples0_row.shape[0]
    samples = samples0_row[None].expand(C, S, M + 1)
    sigma0 = samples0_row[:, M]                              # (S,)
    idx0 = topk_indices(samples0_row[None].contiguous(), k, absolute=True,
                        slice_to=M)[0].long()                # (S, k)
    rows0 = D[:, idx0]                                       # (C, S, k, M)
    rows0_2 = None if D2 is None else D2[:, idx0]
    K_mixed0 = kernel_of(kind, sigma0[None, :, None, None], rows0, rows0_2)
    K_red0 = torch.gather(K_mixed0, 3, idx0[None, :, None, :].expand(C, S, k, k))
    beta_all, cost = finish(*beta_qp(K_red0, K_mixed0.sum(dim=-1), M, rho, reg))
    idx_all = idx0[None].expand(C, S, k)
    mins = []
    for t in range(A_all.shape[0]):
        if t > 0:
            idx_f, beta_f, cost_f = selection_qp_xla(samples[:, n_el:], D, D2, k, kind,
                                                     rho, reg)
            idx_all = torch.cat((el_idx, idx_f), dim=1)
            beta_all = torch.cat((el_beta, beta_f), dim=1)
            cost = torch.cat((el_cost, cost_f), dim=1)
        samples, idx_el, el_cost = resample(samples, cost, A_all[t], Zf_all[t],
                                            lane_floor, n_el)
        el_idx = take_rows(idx_all, idx_el)
        el_beta = take_rows(beta_all, idx_el)
        mins.append(cost.min(dim=1).values)

    # winner of the last iteration; sigma from the post-update batch (the
    # reference's quirk)
    i_min = torch.argmin(cost, dim=1, keepdim=True)          # (C, 1)
    beta_w = take_rows(beta_all, i_min)[:, 0]
    sigma_w = torch.gather(samples[..., M], 1, i_min)[:, 0]
    idx_best = take_rows(idx_all, i_min)[:, 0]               # (C, k)
    return beta_w, sigma_w, idx_best, torch.stack(mins, dim=1)
