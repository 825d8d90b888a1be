"""Kernel (c): the inner beta-CEM of every candidate in one launch (CUDA
source ``csrc/inner_cem.cu``), and its plain version.

The JAX package runs the inner CEM of the "xla" selection with elite-carry
as one ``lax.scan`` (``mpc_mmd_tpu/reduced_set.py:622-717``), which XLA
compiles into one loop on the device.  :func:`inner_cem_plain` is the
port's chain of PyTorch operations for it (K1 for the top-k, gathers, the
kernel values, K2 for the weight QP, K1 for the elite pick and a batched
product for the resample: about 45-50 launches an iteration);
:func:`inner_cem` runs all of it in one kernel launch on the card, a
thread-block cluster of 1, 2 or 4 CTAs a candidate (the kernel picks the
size from the candidate count and the card's occupancy; a candidate's bits
do not depend on it).  ``select_reduced_set_batched`` calls :func:`inner_cem`
for the "xla" selection with elite-carry; the other selections keep their
chains, built from the pieces here (:func:`beta_qp`, :func:`finish`,
:func:`selection_qp_xla`, :func:`resample`).

The inputs are the step before the loop: the (C, M, M) L1 distance matrix
D of every candidate's mother rollouts (and the squared L2 one, D2, for
the gaussian and matern52 kernels), the clipped first batch
``samples0_row`` (S, M+1) that every candidate starts from, the affine
resample's coefficients ``A_all`` (maxiter, S - n_el, n_el) and
``Zf_all`` (maxiter, S - n_el, M+1) and the lane floor (M+1).  What the
kernel must keep and how it is built: see the note at the top of the CUDA
source.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .qp import eq_qp_solve
from .topk import topk_indices
from ..kernels import kernel_of

KINDS = ("laplace", "gaussian", "matern52")   # the kernel's kind argument
MAX_K = 16        # the weight QP's size (k = num_reduced)
MAX_WIDTH = 256   # M, the lanes ranked and the side of D
MAX_SAMPLES = 256

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


def inner_cem_plain(D: torch.Tensor, D2: Optional[torch.Tensor],
                    samples0_row: torch.Tensor, A_all: torch.Tensor,
                    Zf_all: torch.Tensor, lane_floor: torch.Tensor, k: int,
                    n_el: int, rho: float, reg: float, kind: str) -> InnerResult:
    """Plain version: the chain of PyTorch operations (K1 and K2 on the
    card) that the "xla" selection with elite-carry ran before kernel (c).
    Arguments and result as :func:`inner_cem`."""
    C, M = D.shape[0], D.shape[-1]
    S = samples0_row.shape[0]
    samples = samples0_row[None].expand(C, S, M + 1)
    # iteration 0: every candidate starts from the same sample rows, so the
    # top-k is computed once and gathered against each candidate's D
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
            idx_f, beta_f, cost_f = selection_qp_xla(samples[:, n_el:], D, D2, k,
                                                     kind, rho, reg)
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


def _check(D, D2, samples0_row, A_all, Zf_all, lane_floor, k, n_el, kind):
    """(C, S, M, maxiter); raises on arguments neither version takes."""
    if D.dim() != 3 or D.shape[1] != D.shape[2]:
        raise ValueError(f"inner_cem: D {tuple(D.shape)} must be (C, M, M)")
    C, M = D.shape[0], D.shape[-1]
    if kind not in KINDS:
        raise ValueError(f"inner_cem: unknown kernel kind {kind!r} (expected one "
                         f"of {KINDS})")
    if (D2 is None) != (kind == "laplace") or (D2 is not None and D2.shape != D.shape):
        raise ValueError(f"inner_cem: the {kind} kernel takes "
                         f"{'no D2' if kind == 'laplace' else 'D2 of D shape'}")
    if samples0_row.dim() != 2 or samples0_row.shape[1] != M + 1:
        raise ValueError(f"inner_cem: samples0_row {tuple(samples0_row.shape)} "
                         f"must be (S, {M + 1})")
    S = samples0_row.shape[0]
    if not 0 < n_el < S:
        raise ValueError(f"inner_cem: n_el={n_el} outside (0, {S})")
    if not 0 < k <= M:
        raise ValueError(f"inner_cem: k={k} outside (0, {M}]")
    maxiter = A_all.shape[0] if A_all.dim() == 3 else 0
    if (maxiter < 1 or A_all.shape[1:] != (S - n_el, n_el)
            or Zf_all.shape != (maxiter, S - n_el, M + 1)
            or lane_floor.shape != (M + 1,)):
        raise ValueError(f"inner_cem: A_all {tuple(A_all.shape)}, Zf_all "
                         f"{tuple(Zf_all.shape)} and lane_floor "
                         f"{tuple(lane_floor.shape)} do not match S={S}, "
                         f"n_el={n_el}, M={M}")
    return C, S, M, maxiter


def inner_cem(D: torch.Tensor, D2: Optional[torch.Tensor],
              samples0_row: torch.Tensor, A_all: torch.Tensor,
              Zf_all: torch.Tensor, lane_floor: torch.Tensor, k: int, n_el: int,
              rho: float, reg: float, kind: str) -> InnerResult:
    """The inner beta-CEM of every candidate, "xla" selection with
    elite-carry, all ``A_all.shape[0]`` iterations.

    D (C, M, M) and, for the gaussian and matern52 ``kind``, D2 (else
    None); samples0_row (S, M+1); A_all (maxiter, S - n_el, n_el); Zf_all
    (maxiter, S - n_el, M+1); lane_floor (M+1); k = num_reduced, n_el the
    elites, rho and reg the weight QP's ``rho_beta`` and ``qp_reg``.
    Returns (beta_w (C, k), sigma_w (C,), idx_best (C, k) int64, res (C,
    maxiter)): the winner's weights, bandwidth (from the post-update batch)
    and mother-rollout indices, and each iteration's least cost.

    CPU tensors take :func:`inner_cem_plain`; CUDA tensors launch kernel
    (c) (float32, contiguous, one device, k in 2 ... 16, M <= 256, S <=
    256) or raise.
    """
    C, S, M, maxiter = _check(D, D2, samples0_row, A_all, Zf_all, lane_floor, k,
                              n_el, kind)
    inputs = [t for t in (D, D2, samples0_row, A_all, Zf_all, lane_floor)
              if t is not None]
    if all(t.device.type == "cpu" for t in inputs):
        return inner_cem_plain(D, D2, samples0_row, A_all, Zf_all, lane_floor, k,
                               n_el, rho, reg, kind)
    _build.require_cuda_f32("inner_cem", *inputs)
    if not (2 <= k <= MAX_K and M <= MAX_WIDTH and S <= MAX_SAMPLES):
        raise ValueError(f"inner_cem: the kernel takes k in 2 ... {MAX_K}, M <= "
                         f"{MAX_WIDTH} and S <= {MAX_SAMPLES}, got k={k}, M={M}, "
                         f"S={S}")
    lib = _build.library()
    kind_i = KINDS.index(kind)
    per_cand = lib.mmd_inner_cem_scratch(S, M, k, n_el, kind_i)
    if per_cand < 0:
        raise ValueError(f"inner_cem: the kernel refuses S={S}, M={M}, k={k}, "
                         f"n_el={n_el}")
    dev = D.device
    beta_w = torch.empty(C, k, dtype=torch.float32, device=dev)
    sigma_w = torch.empty(C, dtype=torch.float32, device=dev)
    idx_best = torch.empty(C, k, dtype=torch.int64, device=dev)
    res = torch.empty(C, maxiter, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(1, C * per_cand), dtype=torch.float32, device=dev)
    # the float32 constants of the plain chain: -rho * (1 / M) times a
    # tensor, and a division by rho, which PyTorch takes on the card as a
    # product with the float32 reciprocal
    r_scale = float(np.float32(-rho * (1.0 / M)))
    inv_rho = float(np.float32(1.0) / np.float32(rho))
    err = lib.mmd_inner_cem(
        D.data_ptr(), None if D2 is None else D2.data_ptr(), samples0_row.data_ptr(),
        A_all.data_ptr(), Zf_all.data_ptr(), lane_floor.data_ptr(),
        beta_w.data_ptr(), sigma_w.data_ptr(), idx_best.data_ptr(), res.data_ptr(),
        scratch.data_ptr(), C, S, M, k, n_el, maxiter, kind_i, rho, reg, r_scale,
        inv_rho, _build.stream())
    _build.check(err, "inner_cem")
    inner_cem.launches += 1
    return beta_w, sigma_w, idx_best, res


inner_cem.launches = 0


def last_cluster_size() -> int:
    """CTAs a candidate (1, 2 or 4) in the last launch of kernel (c)."""
    return _build.library().mmd_inner_cem_last_cluster()
