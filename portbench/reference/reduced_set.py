# Frozen copy of mpc_mmd_tpu_torch/reduced_set.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Reduced-set selection: the batched inner beta-CEM of every candidate.

Counterpart of ``select_reduced_set_batched`` in
``mpc_mmd_tpu/reduced_set.py`` under its "xla" selection with elite-carry,
the pair the cells' configurations run.  Per candidate, the (M, M) L1
distance matrix of the mother rollouts' coefficients is computed once;
each inner iteration then picks the top-k |beta| lanes of every fresh
sample, gathers those rows of D, takes exp(-rows/sigma) and solves the
k x k weight QP (``inner_cem.py``).  The gathers are direct, which is
exact, so the elite rows and every carried value pass through
bit-unchanged (TF32 is off in any case, see ``__init__``).

The inner CEM update is affine in the elites: the fresh rows are
``A_t @ elites + sqrt(jitter) * z_t`` with A_t built from the draws alone,
and the next batch is ``cat(elites, fresh)``, so rows 0..n_el-1 are the
elites by construction.  Their selection and QP results are carried
instead of recomputed (elite-carry, with a candidate-shared iteration 0).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import ProblemConfig
from .noise import InnerDraws
from .inner_cem import inner_cem, take_rows


class ReducedSet(NamedTuple):
    beta: torch.Tensor      # (C, k) weights; slots in descending-|beta| order
    sigma: torch.Tensor     # (C,) bandwidth, from the post-update batch
    x_red: torch.Tensor     # (C, k, T) reduced rollouts
    y_red: torch.Tensor
    res: torch.Tensor       # (C, maxiter) best MMD residual per iteration


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


def select_reduced_set_batched(cfg: ProblemConfig, x_roll: torch.Tensor,
                               y_roll: torch.Tensor, fixed: InnerFixed,
                               distances: Tuple) -> ReducedSet:
    """Inner CEM over all candidates.

    x_roll, y_roll: (C, M, T) the mother rollouts; ``fixed``:
    :func:`inner_fixed` of the inner CEM's draws, shared by every
    candidate; ``distances``: (D, D2) of the rollouts' refitted
    coefficients (kernel (f)'s stage, ``inner_prologue``).
    """
    b = cfg.beta_cem
    D, D2 = distances
    beta_w, sigma_w, idx_best, res = inner_cem(
        D, D2, *fixed, cfg.risk.num_reduced, b.num_ellite, b.rho_beta, b.qp_reg,
        cfg.risk.kernel)
    return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=take_rows(x_roll, idx_best),
                      y_red=take_rows(y_roll, idx_best), res=res)


