"""Kernel (c): the inner beta-CEM of every candidate in one launch (CUDA
sources ``csrc/inner_cem.cu``, ``csrc/inner_cem_fused.cu`` and the body
they share, ``csrc/inner_cem_body.cuh``), under each of the inner CEM's
selections and either elite-carry setting, and its plain versions.

The JAX package runs the inner CEM as one ``lax.scan``
(``mpc_mmd_tpu/reduced_set.py:622-717``; ``:721-740`` without
elite-carry), which XLA compiles into one loop on the device, with its
selection (``reduced_set.py:395-406``) inside: "xla" (a top-k, gathers of
D's rows and the kernel values), "xt" (the same in the lane-major layout,
K2's lane-major entry), "fused" (the Pallas kernel K3 for the selection
stage) or "g" (every mother row's kernel sum, then a gather, and K_red
from the selected rows' features).  :func:`inner_cem_plain` is the port's
chain of PyTorch operations for each (selection, elite-carry) pair: K1
for the top-k (K3 under "fused"), gathers, the kernel values, K2 for the
weight QP (its lane-major entry under "xt"), K1 for the elite pick and a
batched product for the resample, about 36-50 launches an iteration.
:func:`inner_cem` runs all of it in one kernel launch on the card, a
thread-block cluster of 1, 2 or 4 CTAs a candidate (the kernel picks the
size from the candidate count and the card's occupancy; a candidate's bits
do not depend on it), in the arithmetic of the pair's chain, whose bits it
gives: a form of the kernel a selection (the CUDA source's note).  A row's
selection and weight QP are a function of the row and D alone in every
chain, so each runs on the kernel's elite-carry scheme; without
elite-carry the kernel runs the batch's elites again only where a row's
sums depend on its place in the chain's tensors (M >= 128, M % 4 != 0:
:func:`recomputes`).  ``select_reduced_set_batched`` calls
:func:`inner_cem` for every prefactored selection.

The inputs are the step before the loop: the (C, M, M) L1 distance matrix
D of every candidate's mother rollouts (and the squared L2 one, D2, for
the gaussian and matern52 kernels), the clipped first batch
``samples0_row`` (S, M+1) that every candidate starts from, the affine
resample's coefficients ``A_all`` (maxiter, S - n_el, n_el) and
``Zf_all`` (maxiter, S - n_el, M+1) and the lane floor (M+1); under "g"
also the mother rollouts' coefficients whose L1 distances D are.  What
the kernel must keep and how it is built: see the note at the top of the
CUDA source.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .qp import eq_qp_solve, eq_qp_solve_t
from .topk import topk_indices
from .topk_kernel import topk_kernel_matrices
from ..kernels import kernel_of

KINDS = ("laplace", "gaussian", "matern52")   # the kernel's kind argument
# the inner CEM's selections, each a form of the kernel (its index there)
SELECTIONS = ("xla", "xt", "fused", "g")
MAX_K = 16        # the weight QP's size (k = num_reduced)
MAX_WIDTH = 256   # M, the lanes ranked and the side of D
MAX_SAMPLES = 256

# Bytes of "g"'s exponential temporary (candidates, S', M, M) per block of
# candidates: at the dynamic workload's width (100 x 100 x 100 x 100) one
# call would otherwise hold 400 MB.  Where a row's sums depend on its place
# (M >= 128), the "g" form follows the blocks.
G_BLOCK_BYTES = 64 * 2 ** 20

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


def _beta_qp_t(K_red_t: torch.Tensor, row_sum_t: torch.Tensor, M: int, rho: float,
               reg: float):
    """:func:`beta_qp` in the lane-major layout (the JAX package's
    reduced_set.py:108-139): K_red_t (k, k, B), row_sum_t (k, B); returns
    (beta_t (k, B), mmd (B,)), the QP through K2's lane-major entry."""
    k, B = K_red_t.shape[0], K_red_t.shape[-1]
    eye_flat = torch.eye(k, dtype=K_red_t.dtype, device=K_red_t.device).reshape(k * k, 1)
    cost_t = rho * K_red_t.reshape(k * k, B) + reg * eye_flat
    r_t = (rho / M) * row_sum_t
    beta_t, mu = eq_qp_solve_t(cost_t, r_t.contiguous())
    br = torch.sum(beta_t * r_t, dim=0)
    mmd = (-br - mu - reg * torch.sum(beta_t * beta_t, dim=0)) / rho
    return beta_t, mmd


def inner_cem_plain(D: torch.Tensor, D2: Optional[torch.Tensor],
                    samples0_row: torch.Tensor, A_all: torch.Tensor,
                    Zf_all: torch.Tensor, lane_floor: torch.Tensor, k: int,
                    n_el: int, rho: float, reg: float, kind: str,
                    selection: str = "xla", carry: bool = True,
                    coeffs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    g_block: int = G_BLOCK_BYTES) -> InnerResult:
    """Plain version: the chain of PyTorch operations (K1, K2, K2t and K3
    on the card) of the (selection, elite-carry) pair, as
    ``select_reduced_set_batched`` ran it before kernel (c) took the pair.
    Arguments and result as :func:`inner_cem`.

    "xt" keeps beta lane-major, (k, C, rows) (the JAX package's
    reduced_set.py:513-533): the rows are gathered as (k, C, S', M), K_red
    straight into (k, k, C S') and row_sum into (k, C S'), the layout of
    K2's lane-major entry.  "g" is the reduce-before-gather form
    (reduced_set.py:497-512): every mother row's kernel sum for the
    sample's bandwidth, its (C, S', M, M) exponential taken ``g_block``
    bytes of candidates at a time, then the k selected ones gathered, and
    K_red from the selected rows' features (``coeffs``) by pairwise L1.
    With elite-carry, iteration 0 of "xla" and "xt" computes the top-k of
    the candidate-shared first batch once; without it every row runs in
    every iteration, from the broadcast (C, S, M+1) batch at iteration 0
    (reduced_set.py:721-740; K3 takes its candidate stride of 0).  The
    "fused" chain runs without elite-carry; with it (which only the tests
    run, as the scheme its kernel form rests on) its iteration 0 runs the
    broadcast batch as "g"'s does."""
    C, M = D.shape[0], D.shape[-1]
    S = samples0_row.shape[0]
    dev = D.device
    c_ix = torch.arange(C, device=dev)[:, None, None]
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
                                  K_mixed.sum(dim=-1).reshape(k, Cc * Ss), M, rho, reg)
        return beta_t.reshape(k, Cc, Ss), cost.reshape(Cc, Ss)

    def row_kernel_sums(sigma):
        """G (C, S', M): G[c, s, r] = sum_m exp(-D[c, r, m] / sigma[c, s]),
        the exponential taken a block of candidates at a time."""
        S_sub = sigma.shape[1]
        per = max(1, g_block // (4 * S_sub * M * M))
        return torch.cat([
            torch.exp(-D[lo:lo + per, None] / sigma[lo:lo + per, :, None, None]).sum(-1)
            for lo in range(0, C, per)])

    def selection_qp(samples_sub):
        """Selection and weight QP of the rows (C, S', M+1)."""
        if selection == "xla":
            return selection_qp_xla(samples_sub, D, D2, k, kind, rho, reg)
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
            feats = torch.cat(coeffs, dim=2)
            fsel = feats[c_ix, idx]                          # (C, S', k, F)
            d_sub = torch.sum(torch.abs(fsel[:, :, :, None, :]
                                        - fsel[:, :, None, :, :]), dim=-1)
            K_red = torch.exp(-d_sub / sigma[..., None, None])
        beta, cost = beta_qp(K_red, row_sum, M, rho, reg)
        return (idx,) + finish(beta, cost)

    samples = samples0_row[None].expand(C, S, M + 1)
    mins = []
    if carry:
        if selection in ("fused", "g"):
            idx_all, beta_all, cost = selection_qp(samples)
        else:
            # iteration 0: every candidate starts from the same sample rows,
            # so the top-k is computed once and gathered against each
            # candidate's D
            sigma0 = samples0_row[:, M]                      # (S,)
            idx0 = topk_indices(samples0_row[None].contiguous(), k, absolute=True,
                                slice_to=M)[0].long()        # (S, k)
            if lane_major:
                beta_all, cost = finish(*lane_major_qp(
                    idx0.T[:, None].expand(k, C, S), sigma0.expand(C, S)))
            else:
                rows0 = D[:, idx0]                           # (C, S, k, M)
                rows0_2 = None if D2 is None else D2[:, idx0]
                K_mixed0 = kernel_of(kind, sigma0[None, :, None, None], rows0, rows0_2)
                K_red0 = torch.gather(K_mixed0, 3, idx0[None, :, None, :].expand(C, S, k, k))
                beta_all, cost = finish(*beta_qp(K_red0, K_mixed0.sum(dim=-1), M, rho, reg))
            idx_all = idx0[None].expand(C, S, k)
        for t in range(A_all.shape[0]):
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
        for t in range(A_all.shape[0]):
            idx_all, beta_all, cost = selection_qp(samples)
            samples = resample(samples, cost, A_all[t], Zf_all[t], lane_floor, n_el)[0]
            mins.append(cost.min(dim=1).values)

    # winner of the last iteration; sigma from the post-update batch (the
    # reference's quirk)
    i_min = torch.argmin(cost, dim=1, keepdim=True)          # (C, 1)
    beta_w = take_beta(beta_all, i_min)
    beta_w = beta_w[..., 0].T.contiguous() if lane_major else beta_w[:, 0]
    sigma_w = torch.gather(samples[..., M], 1, i_min)[:, 0]
    idx_best = take_rows(idx_all, i_min)[:, 0]               # (C, k)
    return beta_w, sigma_w, idx_best, torch.stack(mins, dim=1)


def recomputes(selection: str, carry: bool, M: int) -> bool:
    """Whether the kernel runs the batch's elites again in every iteration:
    without elite-carry, where a row's sums of M terms depend on the row's
    place in the chain's tensors (PyTorch's vectorised sum from M = 128 on,
    from the row's first 16-byte boundary, which moves with the place where
    M % 4 != 0).  Elsewhere the carried results are the recomputed ones
    bit for bit.  "fused" sums a row in K3's order, which no place moves."""
    return not carry and selection != "fused" and M >= 128 and M % 4 != 0


def _check(D, D2, samples0_row, A_all, Zf_all, lane_floor, k, n_el, kind, selection,
           carry, coeffs):
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
    if selection not in SELECTIONS:
        raise ValueError(f"inner_cem: unknown selection {selection!r} (expected one of "
                         f"{SELECTIONS})")
    if selection in ("fused", "g") and kind != "laplace":
        raise ValueError(f"inner_cem: the {selection!r} selection takes the laplace "
                         f"kernel only, got {kind!r}")
    if selection == "fused" and carry:
        raise ValueError("inner_cem: the 'fused' selection recomputes every row "
                         "(no elite-carry)")
    if selection == "g" and (coeffs is None or len(coeffs) != 2 or any(
            c.dim() != 3 or c.shape[:2] != (C, M) for c in coeffs)):
        raise ValueError(f"inner_cem: the 'g' selection takes coeffs = (cx, cy), each "
                         f"(C, M, nvar) = ({C}, {M}, nvar), whose L1 distances D are")
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
              rho: float, reg: float, kind: str, selection: str = "xla",
              carry: bool = True, coeffs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              g_block: int = G_BLOCK_BYTES) -> InnerResult:
    """The inner beta-CEM of every candidate, all ``A_all.shape[0]``
    iterations, as the (``selection``, ``carry``) pair's chain computes it.

    D (C, M, M) and, for the gaussian and matern52 ``kind``, D2 (else
    None); samples0_row (S, M+1); A_all (maxiter, S - n_el, n_el); Zf_all
    (maxiter, S - n_el, M+1); lane_floor (M+1); k = num_reduced, n_el the
    elites, rho and reg the weight QP's ``rho_beta`` and ``qp_reg``;
    ``selection`` one of :data:`SELECTIONS` ("fused" and "g" laplace only,
    "fused" without elite-carry); ``coeffs`` = (cx, cy) (C, M, nvar), the
    coefficients whose L1 distances D are, which "g" takes (its plain
    version's K_red; the kernel reads D's entries); ``g_block``: the bytes
    of a block of "g"'s exponential.  Returns (beta_w (C, k), sigma_w
    (C,), idx_best (C, k) int64, res (C, maxiter)): the winner's weights,
    bandwidth (from the post-update batch) and mother-rollout indices, and
    each iteration's least cost.

    CPU tensors take :func:`inner_cem_plain`; CUDA tensors launch kernel
    (c) (float32, contiguous, one device, k in 2 ... 16, M <= 256, S <=
    256) or raise.
    """
    C, S, M, maxiter = _check(D, D2, samples0_row, A_all, Zf_all, lane_floor, k,
                              n_el, kind, selection, carry, coeffs)
    inputs = [t for t in (D, D2, samples0_row, A_all, Zf_all, lane_floor)
              if t is not None]
    if all(t.device.type == "cpu" for t in inputs):
        return inner_cem_plain(D, D2, samples0_row, A_all, Zf_all, lane_floor, k,
                               n_el, rho, reg, kind, selection, carry, coeffs, g_block)
    _build.require_cuda_f32("inner_cem", *inputs)
    if not (2 <= k <= MAX_K and M <= MAX_WIDTH and S <= MAX_SAMPLES):
        raise ValueError(f"inner_cem: the kernel takes k in 2 ... {MAX_K}, M <= "
                         f"{MAX_WIDTH} and S <= {MAX_SAMPLES}, got k={k}, M={M}, "
                         f"S={S}")
    lib = _build.library()
    kind_i, form = KINDS.index(kind), SELECTIONS.index(selection)
    recompute = int(recomputes(selection, carry, M))
    per_cand = lib.mmd_inner_cem_scratch(S, M, k, n_el, kind_i, form, recompute)
    if per_cand < 0:
        raise ValueError(f"inner_cem: the kernel refuses S={S}, M={M}, k={k}, "
                         f"n_el={n_el}, {selection!r}")
    dev = D.device
    beta_w = torch.empty(C, k, dtype=torch.float32, device=dev)
    sigma_w = torch.empty(C, dtype=torch.float32, device=dev)
    idx_best = torch.empty(C, k, dtype=torch.int64, device=dev)
    res = torch.empty(C, maxiter, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(1, C * per_cand), dtype=torch.float32, device=dev)
    # the float32 constants of the plain chains: -rho * (1 / M) times a
    # tensor ("xt": rho / M times it, negated here as the kernel negates the
    # product), and a division by rho, which PyTorch takes on the card as a
    # product with the float32 reciprocal
    r_scale = (-float(np.float32(rho / M)) if selection == "xt"
               else float(np.float32(-rho * (1.0 / M))))
    inv_rho = float(np.float32(1.0) / np.float32(rho))
    err = lib.mmd_inner_cem(
        D.data_ptr(), None if D2 is None else D2.data_ptr(), samples0_row.data_ptr(),
        A_all.data_ptr(), Zf_all.data_ptr(), lane_floor.data_ptr(),
        beta_w.data_ptr(), sigma_w.data_ptr(), idx_best.data_ptr(), res.data_ptr(),
        scratch.data_ptr(), C, S, M, k, n_el, maxiter, kind_i, rho, reg, r_scale,
        inv_rho, form, recompute, g_block // 4, _build.stream())
    _build.check(err, "inner_cem")
    inner_cem.launches += 1
    if selection in FORMS:
        FORMS[selection].launches += 1
    return beta_w, sigma_w, idx_best, res


inner_cem.launches = 0


class FormCount:
    """The launches of one form of kernel (c), counted where
    :func:`inner_cem` launches it (whose own count takes every form);
    ``ops.KERNELS`` lists it beside the wrappers, so that a graph replay
    adds to it what its capture counted."""

    def __init__(self, name: str):
        self.__name__, self.launches = name, 0


# the forms other than "xla", by selection
FORMS = {s: FormCount(f"inner_cem_{s}") for s in ("fused", "xt", "g")}
inner_cem_fused, inner_cem_xt, inner_cem_g = FORMS.values()


def last_cluster_size() -> int:
    """CTAs a candidate (1, 2 or 4) in the last launch of kernel (c)."""
    return _build.library().mmd_inner_cem_last_cluster()
