# Frozen copy of mpc_mmd_tpu_torch/qp.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Equality-constrained QP machinery: workspace precompute and guess QP.

Counterpart of ``mpc_mmd_tpu/qp.py``.  Every KKT matrix on the path is
constant, so it is inverted once on the host in float64 and every
per-iteration solve is one float32 product with that inverse (the
"prefactored" strategy, the cells'; the "exact" one is the port's).  Rows
are candidates, the
candidates of every scenario of a chunk one after another; ``scenarios``
says how many, and every product is ``linalg.scenario_mm``, which gives a
row the bits it has in a solve of its scenario alone.

The package has no trained weights: these prefactored inverses and bases are
its parameters.  :func:`workspace_from_numpy` loads them from arrays, which
is how the tests run both packages on the identical workspace.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .basis import segment_slices, uniform_basis
from .config import ProblemConfig
from .device import resolve_device
from .linalg import scenario_mm


class Workspace(NamedTuple):
    """Setup-time constant tensors (float32 on the solver's device).

    Fields and shapes as in ``mpc_mmd_tpu.qp.Workspace``.
    """

    P: torch.Tensor
    Pdot: torch.Tensor
    Pddot: torch.Tensor
    P_prime: torch.Tensor
    Pdot_prime: torch.Tensor
    Pddot_prime: torch.Tensor
    A_eq_x: torch.Tensor
    A_eq_y: torch.Tensor
    A_lane: torch.Tensor
    guess_kkt_x: torch.Tensor
    guess_kkt_y: torch.Tensor
    guess_kkt_x_inv: torch.Tensor
    guess_kkt_y_inv: torch.Tensor
    G_vx: torch.Tensor
    G_py: torch.Tensor
    proj_kkt_x: torch.Tensor
    proj_kkt_y: torch.Tensor
    proj_kkt_x_inv: torch.Tensor
    proj_kkt_y_inv: torch.Tensor
    refit_inv: torch.Tensor
    tot_time: torch.Tensor


def _kkt(cost: np.ndarray, A_eq: np.ndarray) -> np.ndarray:
    m = A_eq.shape[0]
    return np.block([[cost, A_eq.T], [A_eq, np.zeros((m, m))]])


def _workspace_float64(cfg: ProblemConfig) -> Dict[str, np.ndarray]:
    """Host float64 precompute; the same arithmetic as the JAX package."""
    h, g, pj = cfg.horizon, cfg.guess, cfg.projection
    basis = uniform_basis(h.order, h.t_fin, h.num)
    P, Pdot, Pddot = basis.P, basis.Pdot, basis.Pddot
    nvar = basis.nvar

    t_prime = np.linspace(0.0, h.num_prime * h.dt, h.num_prime)
    basis_p = uniform_basis(h.order, float(t_prime[-1]), h.num_prime)

    A_eq_x = np.vstack((P[0], Pdot[0], Pddot[0]))
    A_eq_y = np.vstack((P[0], Pdot[0], Pddot[0], Pdot[-1]))

    gam = cfg.lane.gamma
    A_ub = P[1:] + (gam - 1.0) * P[:-1]
    A_lb = -P[1:] + (1.0 - gam) * P[:-1]
    A_lane = np.vstack((A_ub, A_lb))

    slices = segment_slices(h.num, g.num_segments)
    cost_gx = g.weight_smoothness_x * Pddot.T @ Pddot
    cost_gy = g.weight_smoothness_y * Pddot.T @ Pddot
    G_vx = np.zeros((g.num_segments, nvar))
    G_py = np.zeros((g.num_segments, nvar))
    for i, sl in enumerate(slices):
        A_vd = Pddot[sl] - g.k_p_v * Pdot[sl]
        A_pd = Pddot[sl] - g.k_p * P[sl]
        cost_gx += g.rho_v * A_vd.T @ A_vd
        cost_gy += g.rho_offset * A_pd.T @ A_pd
        ones = np.ones(sl.stop - sl.start)
        G_vx[i] = g.rho_v * g.k_p_v * (A_vd.T @ ones)
        G_py[i] = g.rho_offset * g.k_p * (A_pd.T @ ones)
    guess_kkt_x = _kkt(cost_gx, A_eq_x)
    guess_kkt_y = _kkt(cost_gy, A_eq_y)

    cost_px = (pj.rho_projection * np.eye(nvar)
               + pj.rho_ineq * (Pddot.T @ Pddot)
               + pj.rho_ineq * (Pdot.T @ Pdot))
    cost_py = cost_px + pj.rho_lane * (A_lane.T @ A_lane)
    if pj.with_obstacle_terms:
        # the obstacle rows tile P once per obstacle circle, so their
        # Gram matrix is that count times P^T P
        n_rows = cfg.obstacles.num_obs * cfg.obstacles.num_circles
        cost_px = cost_px + pj.rho_obs * n_rows * (P.T @ P)
        cost_py = cost_py + pj.rho_obs * n_rows * (P.T @ P)
    proj_kkt_x = _kkt(cost_px, A_eq_x)
    proj_kkt_y = _kkt(cost_py, A_eq_y)

    refit_mat = basis_p.P.T @ basis_p.P + 0.05 * np.eye(nvar)

    return dict(
        P=P, Pdot=Pdot, Pddot=Pddot,
        P_prime=basis_p.P, Pdot_prime=basis_p.Pdot, Pddot_prime=basis_p.Pddot,
        A_eq_x=A_eq_x, A_eq_y=A_eq_y, A_lane=A_lane,
        guess_kkt_x=guess_kkt_x, guess_kkt_y=guess_kkt_y,
        guess_kkt_x_inv=np.linalg.inv(guess_kkt_x),
        guess_kkt_y_inv=np.linalg.inv(guess_kkt_y),
        G_vx=G_vx, G_py=G_py,
        proj_kkt_x=proj_kkt_x, proj_kkt_y=proj_kkt_y,
        proj_kkt_x_inv=np.linalg.inv(proj_kkt_x),
        proj_kkt_y_inv=np.linalg.inv(proj_kkt_y),
        refit_inv=np.linalg.inv(refit_mat),
        tot_time=np.linspace(0.0, h.t_fin, h.num),
    )


def workspace_from_numpy(d: Dict[str, np.ndarray], device) -> Workspace:
    """Build a :class:`Workspace` from arrays keyed by field name.

    The arrays are cast to float32 on the host (so float64 inputs round
    exactly as the JAX package rounds them) and copied to ``device``.
    """
    missing = set(Workspace._fields) - set(d)
    if missing:
        raise KeyError(f"workspace arrays missing: {sorted(missing)}")
    return Workspace(**{
        name: torch.from_numpy(np.array(d[name], dtype=np.float32)).to(device)
        for name in Workspace._fields})


def build_workspace(cfg: ProblemConfig, device="cuda") -> Workspace:
    """Float64 host precompute of every constant matrix, as float32 tensors
    on ``device`` (the card by default; ``device="cpu"`` for the CPU)."""
    return workspace_from_numpy(_workspace_float64(cfg), resolve_device(device))


def kkt_solve(kkt_inv: torch.Tensor, rhs: torch.Tensor, scenarios: int = 1) -> torch.Tensor:
    """Solve KKT @ sol^T = rhs^T for a batch (batch, n) of ``scenarios``
    scenarios' rows by one product with the prefactored inverse."""
    return scenario_mm(rhs, kkt_inv.T, scenarios)


def compute_guess(cfg: ProblemConfig, ws: Workspace, params: torch.Tensor,
                  b_eq_x: torch.Tensor, b_eq_y: torch.Tensor, scenarios: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Behavioral params (batch, 8) of ``scenarios`` scenarios -> Bernstein
    coefficient guess (batch, nvar)."""
    nvar = cfg.horizon.nvar
    nseg = cfg.guess.num_segments
    V = params[:, :nseg]
    Y = params[:, nseg:2 * nseg]
    lincost_x = scenario_mm(V, ws.G_vx, scenarios)
    lincost_y = scenario_mm(Y, ws.G_py, scenarios)
    rhs_x = torch.cat((-lincost_x, b_eq_x), dim=1)
    rhs_y = torch.cat((-lincost_y, b_eq_y), dim=1)
    sol_x = kkt_solve(ws.guess_kkt_x_inv, rhs_x, scenarios)
    sol_y = kkt_solve(ws.guess_kkt_y_inv, rhs_y, scenarios)
    return sol_x[:, :nvar], sol_y[:, :nvar]


def boundary_vectors(cfg: ProblemConfig, init_state: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equality right-hand sides replicated over the candidate batch.

    init_state: (6,) = [x, y, vx, vy, ax, ay].
    """
    nb = cfg.cem.num_batch
    ones = torch.ones((nb, 1), dtype=init_state.dtype, device=init_state.device)
    x0, y0, vx0, vy0, ax0, ay0 = (init_state[i] for i in range(6))
    b_eq_x = torch.cat((x0 * ones, vx0 * ones, ax0 * ones), dim=1)
    b_eq_y = torch.cat((y0 * ones, vy0 * ones, ay0 * ones,
                        torch.zeros_like(ones)), dim=1)
    return b_eq_x, b_eq_y


def refit_coefficients(ws: Workspace, x: torch.Tensor, y: torch.Tensor,
                       scenarios: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ridge-regularised Bernstein fit of rollouts (..., B, num_prime) of
    ``scenarios`` scenarios."""
    fit = lambda t: scenario_mm(scenario_mm(t, ws.P_prime, scenarios),
                                ws.refit_inv.T, scenarios)
    cx, cy = fit(x), fit(y)
    return cx, cy
