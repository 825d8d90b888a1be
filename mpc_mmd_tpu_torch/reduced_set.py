"""Reduced-set selection: the batched inner beta-CEM of every candidate.

Counterpart of ``select_reduced_set_batched`` in
``mpc_mmd_tpu/reduced_set.py`` with its four selections ("xla", "xt",
"fused" and "g"), and of ``select_reduced_set`` under the "exact" strategy
(see :func:`select_reduced_set`).

Per candidate, the (M, M) L1 distance matrix of the mother rollouts'
coefficients is computed once; each inner iteration then runs the
selection stage on every sample and solves the k x k weight QP.  The
"xla" selection picks the top-k |beta| lanes, gathers those rows of D and
takes exp(-rows/sigma); "xt" is "xla" in the lane-major layout with K2's
lane-major entry; "fused" does the selection stage as K3 does; "g" sums
every mother row's kernel values before gathering the selected ones.
Every (selection, elite-carry) pair is one launch of kernel (c) an outer
iteration on the card (``ops.inner_cem``: every iteration of every
candidate, in the pair's own arithmetic), and its plain version is the
pair's chain of K1, K2 / K2t / K3 and PyTorch's operations
(``ops.inner_cem.inner_cem_plain``), which the CPU runs; see
``ops/inner_cem.py``.  Under the gaussian and matern52 kernels the "xla"
and "xt" selections also read the squared L2 distance matrix D2.  The JAX
package writes the gathers as one-hot einsums to suit the TPU; here they
are direct gathers, which are exact, so the elite rows and every carried
value pass through bit-unchanged (TF32 is off in any case, see
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
``MPC_MMD_ELITE_CARRY=0``, recompute every row in every iteration, from
the broadcast (C, S, M+1) batch at iteration 0 (reduced_set.py:721-740);
a row's results depend on the row and D alone, so kernel (c) gives those
chains' bits from its elite-carry scheme.
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
from .ops import inner_cem
from .ops.inner_cem import G_BLOCK_BYTES, SELECTIONS, take_rows


class ReducedSet(NamedTuple):
    beta: torch.Tensor      # (C, k) weights; slots in descending-|beta| order
    #                       # on the fast path, ascending under "exact"
    sigma: torch.Tensor     # (C,) bandwidth, from the post-update batch
    x_red: torch.Tensor     # (C, k, T) reduced rollouts
    y_red: torch.Tensor
    res: torch.Tensor       # (C, maxiter) best MMD residual per iteration


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
    D, D2 = (distances if distances is not None
             else distance_matrices(cx, cy, cfg.risk.kernel))
    inner = fixed if fixed is not None else inner_fixed(cfg, draws)
    # on the card the pair's form of kernel (c) (faster than every chain at
    # every path shape, PERF.md); on the CPU the wrapper runs the chain
    beta_w, sigma_w, idx_best, res = inner_cem(
        D, D2, *inner, cfg.risk.num_reduced, b.num_ellite, b.rho_beta, b.qp_reg,
        cfg.risk.kernel, selection=selection, carry=elite_carry,
        coeffs=(cx, cy) if selection == "g" else None, g_block=G_BLOCK_BYTES)
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=take_rows(x_roll, idx_best),
                      y_red=take_rows(y_roll, idx_best), res=res)


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
