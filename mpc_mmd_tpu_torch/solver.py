"""Outer CEM solver: the risk-aware MPC solve in ``mmd_opt`` mode.

Counterpart of ``mpc_mmd_tpu/solver.py`` for the main path.  One outer
iteration:

  guess QP -> AM projection -> stable sort by projection residual ->
  controls -> 100 mother rollouts per candidate (K4) -> Bernstein refit ->
  inner beta-CEM reduced-set selection (K1, K2) -> MMD obstacle risk ->
  keep the ellite_num_cost lowest risks -> lane risk -> scalar cost ->
  elites -> CEM update.

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
that leaves every value on the device (no host synchronisation inside a
solve).  Every sort is stable, as ``jnp.argsort`` is.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import risk as risk_mod
from .config import ProblemConfig
from .dynamics import controls_from_trajectory, perturb_controls
from .noise import TorchNoise
from .ops import fused_rollout
from .projection import project
from .qp import (Workspace, boundary_vectors, build_workspace, compute_guess,
                 refit_coefficients)
from .reduced_set import select_reduced_set_batched
from .sampling import cem_update, initial_params, scalar_cost


class SolveResult(NamedTuple):
    """Per-solve outputs, as ``mpc_mmd_tpu.solver.SolveResult``."""

    cx: torch.Tensor          # (nvar,) best-candidate Bernstein x coefficients
    cy: torch.Tensor
    risk_lane: torch.Tensor   # ()
    risk_obs: torch.Tensor    # ()
    beta: torch.Tensor        # (num_reduced,)
    sigma: torch.Tensor       # ()
    res_beta: torch.Tensor    # (beta_cem.maxiter,)
    res: torch.Tensor         # (maxiter_cem,) best scalar cost per iteration
    res_2: torch.Tensor       # (maxiter_cem,) projection residual of the best
    mean_param: torch.Tensor  # (8,)
    cov_param: torch.Tensor   # (8, 8)


def batched_rollouts(cfg: ProblemConfig, eps, acc_T: torch.Tensor,
                     steer_T: torch.Tensor, state0: torch.Tensor):
    """Mother rollouts of every candidate as one flat-lane rollout call.

    acc_T, steer_T: (C, T); eps: the (R, T) draws (acc, steer, const),
    shared by all candidates; state0 (5,).  Mother row m pairs acc draw
    m // R with steer draw m % R.  Returns x, y of shape (C, R^2, T).
    """
    C, T = acc_T.shape
    R = cfg.risk.num_reduced
    a_n, s_n = perturb_controls(acc_T, steer_T, *eps, cfg.noise)   # (C, R, T)
    a_l = torch.repeat_interleave(a_n, R, dim=1)
    s_l = s_n.repeat(1, R, 1)
    n = a_l.shape[1]
    x, y = fused_rollout(a_l.reshape(C * n, T), s_l.reshape(C * n, T), state0,
                         cfg.horizon.dt, cfg.vehicle.wheel_base)
    return x.reshape(C, n, T), y.reshape(C, n, T)


class Solver:
    """Builds the workspace and the fixed draws once; ``solve`` runs one MPC
    solve on ``device``.

    Usage::

        solver = Solver(fastrt_workload(), device="cuda")
        result = solver.solve(seed, init_state, mean, cov, x_obs, y_obs, v_des)

    ``noise`` defaults to :class:`TorchNoise` on ``device``.  On a CUDA
    device the rollouts, top-k selections and weight QPs run the hand-written
    kernels (``ops``); on the CPU their plain twins.
    """

    def __init__(self, cfg: ProblemConfig, device="cpu", noise=None,
                 ws: Optional[Workspace] = None):
        if cfg.risk.mode != "mmd_opt":
            raise NotImplementedError(
                f"the PyTorch port has only mode 'mmd_opt', got {cfg.risk.mode!r}")
        if cfg.solve_strategy != "prefactored":
            raise NotImplementedError("the PyTorch port has only the "
                                      "'prefactored' solve strategy")
        if cfg.rollout_backend != "auto":
            raise NotImplementedError("the PyTorch port has only "
                                      "rollout_backend='auto'")
        if cfg.cem.maxiter_cem < 1 or cfg.beta_cem.maxiter < 1:
            raise ValueError("maxiter_cem and beta_cem.maxiter must be >= 1")
        self.cfg = cfg
        self.device = torch.device(device)
        self.ws = ws if ws is not None else build_workspace(cfg, self.device)
        if noise is None:
            noise = TorchNoise(torch.Generator(device=self.device), self.device)
        self.noise = noise
        c, bc = cfg.cem, cfg.beta_cem
        self._z0 = noise.initial_z(c.num_batch, c.num_params)
        self._inner = noise.inner_cem(bc.num_samples_cem, cfg.risk.num_mother,
                                      bc.num_ellite, bc.maxiter)

    def _tensor(self, a) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = np.array(a, dtype=np.float32)   # a copy: inputs stay untouched
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def solve(self, idx_mpc: int, init_state, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des) -> SolveResult:
        """One MPC solve; arguments as ``mpc_mmd_tpu.Solver.solve``.

        init_state (6,) = [x, y, vx, vy, ax, ay]; mean_param (8,),
        cov_param (8, 8); x_obs_traj, y_obs_traj (num_obs, num); v_des a
        float.  Arrays may be numpy, tensors or sequences.
        """
        cfg, ws, noise = self.cfg, self.ws, self.noise
        nb = cfg.cem.num_batch
        n_cost = cfg.cem.ellite_num_cost
        n_el = cfg.cem.ellite_num
        T = cfg.horizon.num_prime
        R = cfg.risk.num_reduced
        M = cfg.risk.num_mother
        nvar = cfg.horizon.nvar
        w_lane, w_obs = cfg.risk.weights()

        init_state = self._tensor(init_state)
        mean = self._tensor(mean_param)
        cov = self._tensor(cov_param)
        x_obs_T = self._tensor(x_obs_traj)[:, :T]
        y_obs_T = self._tensor(y_obs_traj)[:, :T]

        params = initial_params(cfg, mean, cov, self._z0)
        b_eq_x, b_eq_y = boundary_vectors(cfg, init_state)
        state0 = torch.stack((init_state[0], init_state[1], init_state[2],
                              init_state[3],
                              torch.atan2(init_state[3], init_state[2])))

        zeros = lambda *s: torch.zeros(s, device=self.device)
        lamda_x, lamda_y = zeros(nb, nvar), zeros(nb, nvar)
        s_lane = zeros(nb, 2 * (cfg.horizon.num - 1))
        res, res_2 = zeros(cfg.cem.maxiter_cem), zeros(cfg.cem.maxiter_cem)

        for it in range(cfg.cem.maxiter_cem):
            eps = noise.rollout_eps(idx_mpc, it, R, T)
            cem_z = noise.cem_z(idx_mpc, it, nb - n_el, cfg.cem.num_params)

            cx_bar, cy_bar = compute_guess(cfg, ws, params, b_eq_x, b_eq_y)
            pr = project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y,
                         lamda_x, lamda_y, s_lane)

            order = torch.argsort(pr.res_norm, stable=True)
            x, y, xdot, ydot, xddot, yddot, c_x, c_y = (
                t[order] for t in (pr.x, pr.y, pr.xdot, pr.ydot, pr.xddot,
                                   pr.yddot, pr.c_x, pr.c_y))
            res_p, params_p = pr.res_norm[order], params[order]

            acc, steer = controls_from_trajectory(
                xdot, ydot, xddot, yddot, cfg.horizon.dt, cfg.vehicle.wheel_base)
            acc_T = acc[:, :T].contiguous()
            steer_T = steer[:, :T].contiguous()

            xr, yr = batched_rollouts(cfg, eps, acc_T, steer_T, state0)
            cxr, cyr = refit_coefficients(ws, xr.reshape(nb * M, T),
                                          yr.reshape(nb * M, T))
            rs = select_reduced_set_batched(cfg, cxr.reshape(nb, M, nvar),
                                            cyr.reshape(nb, M, nvar), xr, yr,
                                            self._inner)
            risk_obs = risk_mod.mmd_obs(cfg, rs.beta, rs.sigma, rs.x_red,
                                        rs.y_red, x_obs_T, y_obs_T)

            order2 = torch.argsort(risk_obs, stable=True)[:n_cost]
            (risk_obs_e, y_e, xdot_e, ydot_e, xddot_e, yddot_e, c_x_e, c_y_e,
             res_e, params_e, steer_e, y_roll_e, beta_e, sigma_e,
             res_beta_e) = (t[order2] for t in (
                 risk_obs, y, xdot, ydot, xddot, yddot, c_x, c_y, res_p,
                 params_p, steer, rs.y_red, rs.beta, rs.sigma, rs.res))

            risk_lane = risk_mod.mmd_lane(cfg, beta_e, sigma_e, y_roll_e)
            cost_batch = scalar_cost(cfg, w_obs * risk_obs_e, w_lane * risk_lane,
                                     y_e, res_e, xdot_e, ydot_e, xddot_e,
                                     yddot_e, steer_e, v_des)

            elite_idx = torch.argsort(cost_batch, stable=True)[:n_el]
            params_elite = params_e[elite_idx]
            cost_elite = cost_batch[elite_idx]
            mean, cov, params = cem_update(cfg, cem_z, params_elite, cost_elite,
                                           mean, cov)

            # The reference's final-selection quirk: the argmin over the
            # SORTED elite costs (so 0) indexes the risk-sorted arrays.
            idx_min = torch.argmin(cost_elite)
            res[it] = torch.min(cost_elite)
            res_2[it] = res_e[idx_min]
            out = (c_x_e[idx_min], c_y_e[idx_min], risk_lane[idx_min],
                   risk_obs_e[idx_min], beta_e[idx_min], sigma_e[idx_min],
                   res_beta_e[idx_min])
            lamda_x, lamda_y, s_lane = pr.lamda_x, pr.lamda_y, pr.s_lane

        cx, cy, risk_lane_b, risk_obs_b, beta_b, sigma_b, res_beta_b = out
        return SolveResult(cx=cx, cy=cy, risk_lane=risk_lane_b,
                           risk_obs=risk_obs_b, beta=beta_b, sigma=sigma_b,
                           res_beta=res_beta_b, res=res, res_2=res_2,
                           mean_param=mean, cov_param=cov)
