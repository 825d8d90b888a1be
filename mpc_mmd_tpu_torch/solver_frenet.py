"""The on-road solver: the outer CEM in the Frenet frame of a local path.

Counterpart of ``mpc_mmd_tpu/solver_frenet.py``.  What differs from the
straight-road solve (``solver.py``):

* n noisy initial states, (x, y) perturbed from ``init_state_z`` (see
  :mod:`mpc_mmd_tpu_torch.noise`; n is ``init_state_count``);
* the equality boundary conditions from the mean of their Frenet states;
* the projection in the Frenet frame, with the curvature-coupled steering
  as the candidates' steer;
* rollouts in the GLOBAL frame, lane m of every candidate from state m
  (K4 with a state per lane), converted pointwise to Frenet for the risks;
* the scalar cost gains the centripetal-acceleration and desired-lane
  terms, and ``mmd_random`` keeps its lane risk;
* ``det`` runs the obstacle-active projection (``with_obstacle_terms`` is
  forced on), one initial state and no rollout, with every risk zero;
* the result carries the best candidate's speed and steering profiles
  and the final CEM moments (``mean_param`` warm-starts the next step).

The outer loop is ``solver.py``'s (``SolverSetup._outer_cem``): Python
over outer iterations, with no host synchronisation inside a solve and
every sort stable; this module supplies its hooks, which take the loop's
leading scenario axis and run at N = 1 (the JAX ``FrenetSolver`` has no
``solve_batch``).  The "exact" strategy runs the reference-parity inner
CEM and KKT solves, as in ``solver.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import risk as risk_mod
from .config import ProblemConfig
from .frenet import FrenetFrame, global_to_frenet_points, global_to_frenet_state
from .noise import init_state_count
from .qp import Workspace
from .sampling import scalar_cost
from .solver import (MODES, SolverSetup, batched_rollouts, noisy_controls,
                     select_reduced)

FRENET_MODES = MODES + ("det",)


class FrenetSolveResult(NamedTuple):
    cx: torch.Tensor             # (nvar,)
    cy: torch.Tensor
    v_best: torch.Tensor         # (num,) speed profile of the best candidate
    steering_best: torch.Tensor  # (num,) its curvature-coupled steering
    mean_param: torch.Tensor     # (8,)
    cov_param: torch.Tensor      # (8, 8)
    res: torch.Tensor            # (maxiter_cem,) best scalar cost per iteration
    risk_obs: torch.Tensor       # ()


def frenet_scalar_cost(cfg: ProblemConfig, risk_des_lane, risk_obs, risk_lane,
                       y, res_norm, xdot, ydot, xddot, yddot, steering,
                       kappa_interp, v_des):
    """The straight-road trajectory cost with its risks zeroed, plus the
    weighted product of the distances to the two lane centres and the
    centripetal penalty, plus the (pre-weighted) risks."""
    zeros = torch.zeros_like(risk_obs)
    base = scalar_cost(cfg, zeros, zeros, y, res_norm, xdot, ydot, xddot,
                       yddot, steering, v_des)
    norm = torch.linalg.vector_norm
    c1 = norm(y - cfg.lane.y_des_1, dim=-1)
    c2 = norm(y - cfg.lane.y_des_2, dim=-1)
    centr = torch.abs((xdot ** 2) * kappa_interp)
    centr_cost = norm(torch.clamp(centr - cfg.vehicle.a_centr, min=0.0), dim=-1)
    return (base + cfg.frenet.weight_des_lane * c1 * c2
            + cfg.frenet.weight_centr * centr_cost
            + risk_obs + risk_lane + risk_des_lane)


class FrenetSolver(SolverSetup):
    """Builds the workspace and the solver-fixed draws once; ``solve`` runs
    one on-road MPC solve on ``device``.

    Usage::

        solver = FrenetSolver(onroad_workload(mode="cvar"))   # on the card
        r = solver.solve(idx_mpc, init_state_global, mean, cov,
                         x_obs_traj, y_obs_traj, v_des, frame)

    Modes ``mmd_opt``, ``mmd_random``, ``cvar``, ``saa`` and ``det``, the
    "prefactored" and "exact" strategies, and the selections of
    :class:`mpc_mmd_tpu_torch.solver.Solver`.  ``device`` defaults to
    ``"cuda"`` and raises without a card; pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, cfg: ProblemConfig, device="cuda", noise=None,
                 ws: Optional[Workspace] = None):
        if cfg.risk.mode == "det" and not cfg.projection.with_obstacle_terms:
            cfg = cfg.replace(projection=dataclasses.replace(
                cfg.projection, with_obstacle_terms=True))
        super().__init__(cfg, device, noise, ws, FRENET_MODES)

    def _initial_states(self, frame: FrenetFrame, idx_mpc: int,
                        init_state_global: torch.Tensor):
        """The noisy initial states (n, 5) [x, y, vx, vy, psi] and the
        Frenet boundary rows (b_eq_x, b_eq_y) from the mean of their
        Frenet states."""
        cfg = self.cfg
        x_g, y_g, v_g, vdot_g, psi_g, psidot_g = init_state_global.unbind(0)
        vx_g = v_g * torch.cos(psi_g)
        vy_g = v_g * torch.sin(psi_g)
        n = init_state_count(cfg)
        z = self.noise.init_state_z(idx_mpc, n)
        mu, sig = cfg.frenet.init_mu, cfg.frenet.init_sigma
        xs = x_g + z[:, 0] * sig[0] + mu[0]
        ys = y_g + z[:, 1] * sig[1] + mu[1]
        ones = torch.ones(n, device=self.device)
        vxs, vys = vx_g * ones, vy_g * ones
        psis = torch.atan2(vy_g, vx_g) * ones
        temps = torch.stack((xs, ys, torch.sqrt(vxs ** 2 + vys ** 2),
                             vdot_g * ones, psis, psidot_g * ones), dim=1)
        conv = global_to_frenet_state(frame, temps)
        s_m, l_m, vs_m, vl_m, as_m, al_m = (c.sum() * (1.0 / n) for c in conv[:6])
        nb1 = torch.ones((cfg.cem.num_batch, 1), device=self.device)
        b_eq_x = torch.cat((s_m * nb1, vs_m * nb1, as_m * nb1), dim=1)
        b_eq_y = torch.cat((l_m * nb1, vl_m * nb1, al_m * nb1,
                            torch.zeros_like(nb1)), dim=1)
        return torch.stack((xs, ys, vxs, vys, psis), dim=1), b_eq_x, b_eq_y

    BEST = ("cx", "cy", "steer", "risk_obs")

    def _project_kwargs(self, ctx):
        frame, _ = ctx
        return dict(arc_vec=frame.arc_vec, kappa=frame.kappa)

    def _steering(self, ctx, pr, in_order, steer):
        """The projection's curvature-coupled steering and the path
        curvature under each candidate, in residual order."""
        return {"steer": in_order(pr.steering), "kappa": in_order(pr.kappa_interp)}

    def _risks(self, ctx, it, seeds, acc_T, steer_T, x_obs_T, y_obs_T):
        """Obstacle risk (N, C) and, per candidate, the Frenet lateral
        offsets of the rollouts the lane risks read (N, C, R, T), beta
        (N, C, R) and sigma (N, C)."""
        frame, states0 = ctx
        cfg = self.cfg
        lead, R, T = acc_T.shape[:-1], cfg.risk.num_reduced, acc_T.shape[-1]
        mode = cfg.risk.mode
        beta = torch.full(lead + (R,), 1.0 / R, device=self.device)
        sigma = torch.full(lead, 0.01, device=self.device)
        if mode == "det":
            return torch.zeros(lead, device=self.device), dict(
                roll=torch.zeros(lead + (R, T), device=self.device), beta=beta,
                sigma=sigma)
        a_n, s_n = noisy_controls(cfg, self.noise, seeds, it, acc_T, steer_T)
        xg, yg = batched_rollouts(cfg, a_n, s_n, states0,
                                  mother=mode == "mmd_opt")
        if mode == "mmd_opt":
            rs = select_reduced(cfg, self.ws, xg, yg, self._inner)
            xg, yg, beta, sigma = rs.x_red, rs.y_red, rs.beta, rs.sigma
        s_roll, l_roll = global_to_frenet_points(frame, xg, yg)
        if mode in ("mmd_opt", "mmd_random"):
            risk_obs = risk_mod.mmd_obs(cfg, beta, sigma, s_roll, l_roll,
                                        x_obs_T, y_obs_T)
        elif mode == "cvar":
            risk_obs = risk_mod.cvar_obs(cfg, s_roll, l_roll, x_obs_T, y_obs_T)
        else:
            risk_obs = risk_mod.saa_obs(cfg, s_roll, l_roll, x_obs_T, y_obs_T)
        return risk_obs, dict(roll=l_roll, beta=beta, sigma=sigma)

    def _lane_risks(self, beta_e, sigma_e, l_roll_e):
        """(lane risk, weighted desired-lane risk) of the kept candidates."""
        cfg = self.cfg
        mode = cfg.risk.mode
        zeros = torch.zeros(sigma_e.shape, device=self.device)
        if mode == "det":
            return zeros, zeros
        mmd = mode in ("mmd_opt", "mmd_random")
        if mmd:
            lane = risk_mod.mmd_lane(cfg, beta_e, sigma_e, l_roll_e)
        elif mode == "cvar":
            lane = risk_mod.cvar_lane(cfg, l_roll_e)
        else:
            lane = risk_mod.saa_lane(cfg, l_roll_e)
        w_des = cfg.risk.weight_lane_des
        if w_des == 0.0:
            return lane, zeros
        if mmd:
            des = risk_mod.mmd_lane_des(cfg, beta_e, sigma_e, l_roll_e)
        elif mode == "cvar":
            des = risk_mod.cvar_lane_des(cfg, l_roll_e)
        else:
            des = risk_mod.saa_lane_des(cfg, l_roll_e)
        return lane, w_des * des

    def _cost(self, k, v_des):
        w_lane, w_obs = self.cfg.risk.weights()
        k["risk_lane"], k["risk_des"] = self._lane_risks(k["beta"], k["sigma"],
                                                         k["roll"])
        return frenet_scalar_cost(
            self.cfg, k["risk_des"], w_obs * k["risk_obs"], w_lane * k["risk_lane"],
            k["y"], k["res_norm"], k["xdot"], k["ydot"], k["xddot"], k["yddot"],
            k["steer"], k["kappa"], v_des)

    @torch.no_grad()
    def solve(self, idx_mpc: int, init_state_global, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des, frame: FrenetFrame
              ) -> FrenetSolveResult:
        """One on-road solve; arguments as ``mpc_mmd_tpu.FrenetSolver.solve``.

        init_state_global (6,) = [x, y, v, vdot, psi, psidot] in the frame
        of ``frame``'s path; mean_param (8,), cov_param (8, 8);
        x_obs_traj, y_obs_traj (num_obs, num) the obstacles' Frenet
        trajectories (s, l); v_des a float; ``frame`` the path's
        :class:`~mpc_mmd_tpu_torch.frenet.FrenetFrame`.
        """
        frame = FrenetFrame(*(self._tensor(t) for t in frame))
        states0, b_eq_x, b_eq_y = self._initial_states(
            frame, idx_mpc, self._tensor(init_state_global))
        best, res, _, mean, cov = self._outer_cem(
            [int(idx_mpc)], (frame, states0), b_eq_x, b_eq_y,
            self._tensor(mean_param), self._tensor(cov_param),
            self._tensor(x_obs_traj)[None], self._tensor(y_obs_traj)[None], v_des)
        best = {name: t[0] for name, t in best.items()}
        res, mean, cov = res[0], mean[0], cov[0]
        Pdot = self.ws.Pdot
        v_best = torch.sqrt((Pdot @ best["cx"]) ** 2 + (Pdot @ best["cy"]) ** 2)
        return FrenetSolveResult(cx=best["cx"], cy=best["cy"], v_best=v_best,
                                 steering_best=best["steer"], mean_param=mean,
                                 cov_param=cov, res=res,
                                 risk_obs=best["risk_obs"])
