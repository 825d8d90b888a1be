"""Alternating-minimisation feasibility projection (stochastic variant).

Counterpart of ``project`` in ``mpc_mmd_tpu/projection.py`` with
``with_obstacle_terms=False`` and no Frenet inputs (so its result has no
Frenet steering or curvature fields): obstacles are handled by the risk
cost, so each AM round is two matmuls with the prefactored KKT
inverses plus elementwise trigonometry.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .config import ProblemConfig
from .qp import Workspace, kkt_solve


class ProjectionResult(NamedTuple):
    c_x: torch.Tensor        # (batch, nvar)
    c_y: torch.Tensor
    x: torch.Tensor          # (batch, num)
    y: torch.Tensor
    xdot: torch.Tensor
    ydot: torch.Tensor
    xddot: torch.Tensor
    yddot: torch.Tensor
    res_norm: torch.Tensor   # (batch,)
    lamda_x: torch.Tensor    # (batch, nvar)
    lamda_y: torch.Tensor
    s_lane: torch.Tensor     # (batch, 2*(num-1))


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """``jnp.unwrap(p, axis=-1)`` with period 2 pi, written out in torch.

    Adds multiples of 2 pi wherever a step exceeds pi, with the same
    boundary rule as numpy and JAX: a step of exactly +pi stays +pi.
    """
    period = torch.tensor(2.0 * math.pi, dtype=p.dtype, device=p.device)
    interval = period / 2
    dd = torch.diff(p, dim=-1)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval,
                             torch.zeros_like(dd), ddmod - dd)
    return torch.cat((p[..., :1], p[..., 1:] + torch.cumsum(ph_correct, dim=-1)),
                     dim=-1)


def _polar_clip(wx, wy, rho, lo, hi, unwrap_angle: bool):
    """w ~ d [cos a, sin a] with d clipped to [lo, hi]; returns (alpha, d)."""
    alpha = torch.atan2(wy, wx)
    if unwrap_angle:
        alpha = unwrap(alpha)
    c1 = rho * (torch.cos(alpha) ** 2 + torch.sin(alpha) ** 2)
    c2 = rho * (wx * torch.cos(alpha) + wy * torch.sin(alpha))
    return alpha, torch.clamp(c2 / c1, lo, hi)


def project(cfg: ProblemConfig, ws: Workspace,
            c_x_bar: torch.Tensor, c_y_bar: torch.Tensor,
            b_eq_x: torch.Tensor, b_eq_y: torch.Tensor,
            lamda_x: torch.Tensor, lamda_y: torch.Tensor,
            s_lane: torch.Tensor) -> ProjectionResult:
    """Project guess coefficients onto the feasible set (AM iterations).

    One polar initialisation with the multiplier pre-update, then
    ``projection.maxiter`` rounds of QP solve, polar re-estimate and
    multiplier update.  Multipliers and lane slack are warm-started across
    outer CEM iterations by the caller.
    """
    pj, veh, lane = cfg.projection, cfg.vehicle, cfg.lane
    if pj.with_obstacle_terms:
        raise NotImplementedError("the PyTorch port has only the stochastic "
                                  "projection (with_obstacle_terms=False)")
    if pj.maxiter < 1:
        raise ValueError("projection.maxiter must be at least 1")
    nvar = cfg.horizon.nvar
    num = cfg.horizon.num

    xdot_g = c_x_bar @ ws.Pdot.T
    ydot_g = c_y_bar @ ws.Pdot.T
    xddot_g = c_x_bar @ ws.Pddot.T
    yddot_g = c_y_bar @ ws.Pddot.T

    alpha_v, d_v = _polar_clip(xdot_g, ydot_g, pj.rho_ineq,
                               veh.v_min, veh.v_max, unwrap_angle=True)
    alpha_a, d_a = _polar_clip(xddot_g, yddot_g, pj.rho_ineq,
                               0.0, veh.a_max, unwrap_angle=True)

    res_vx = xdot_g - d_v * torch.cos(alpha_v)
    res_vy = ydot_g - d_v * torch.sin(alpha_v)
    res_ax = xddot_g - d_a * torch.cos(alpha_a)
    res_ay = yddot_g - d_a * torch.sin(alpha_a)

    lamda_x = lamda_x - pj.rho_ineq * (res_ax @ ws.Pddot) - pj.rho_ineq * (res_vx @ ws.Pdot)
    lamda_y = lamda_y - pj.rho_ineq * (res_ay @ ws.Pddot) - pj.rho_ineq * (res_vy @ ws.Pdot)

    b_lane_ub = pj.gamma * lane.y_ub * torch.ones_like(s_lane[:, :num - 1])
    b_lane_lb = -pj.gamma * lane.y_lb * torch.ones_like(s_lane[:, :num - 1])
    b_lane = torch.cat((b_lane_ub, b_lane_lb), dim=1)

    for _ in range(pj.maxiter):
        b_lane_aug = b_lane - s_lane
        b_vx = d_v * torch.cos(alpha_v)
        b_vy = d_v * torch.sin(alpha_v)
        b_ax = d_a * torch.cos(alpha_a)
        b_ay = d_a * torch.sin(alpha_a)

        lincost_x = (-lamda_x - pj.rho_projection * c_x_bar
                     - pj.rho_ineq * (b_ax @ ws.Pddot)
                     - pj.rho_ineq * (b_vx @ ws.Pdot))
        lincost_y = (-lamda_y - pj.rho_projection * c_y_bar
                     - pj.rho_ineq * (b_ay @ ws.Pddot)
                     - pj.rho_ineq * (b_vy @ ws.Pdot)
                     - pj.rho_lane * (b_lane_aug @ ws.A_lane))

        sol_x = kkt_solve(ws.proj_kkt_x_inv, torch.cat((-lincost_x, b_eq_x), dim=1))
        sol_y = kkt_solve(ws.proj_kkt_y_inv, torch.cat((-lincost_y, b_eq_y), dim=1))
        c_x = sol_x[:, :nvar]
        c_y = sol_y[:, :nvar]

        x = c_x @ ws.P.T
        y = c_y @ ws.P.T
        xdot = c_x @ ws.Pdot.T
        ydot = c_y @ ws.Pdot.T
        xddot = c_x @ ws.Pddot.T
        yddot = c_y @ ws.Pddot.T

        lane_val = c_y @ ws.A_lane.T
        s_lane = torch.clamp(-lane_val + b_lane, min=0.0)
        res_lane = lane_val - b_lane + s_lane

        alpha_v, d_v = _polar_clip(xdot, ydot, pj.rho_ineq,
                                   veh.v_min, veh.v_max, unwrap_angle=False)
        alpha_a, d_a = _polar_clip(xddot, yddot, pj.rho_ineq,
                                   0.0, veh.a_max, unwrap_angle=False)

        res_vx = xdot - d_v * torch.cos(alpha_v)
        res_vy = ydot - d_v * torch.sin(alpha_v)
        res_ax = xddot - d_a * torch.cos(alpha_a)
        res_ay = yddot - d_a * torch.sin(alpha_a)

        res_norm = (torch.linalg.vector_norm(torch.cat((res_ax, res_ay), dim=1), dim=1)
                    + torch.linalg.vector_norm(torch.cat((res_vx, res_vy), dim=1), dim=1)
                    + torch.linalg.vector_norm(res_lane, dim=1))

        lamda_x = (lamda_x - pj.rho_ineq * (res_ax @ ws.Pddot)
                   - pj.rho_ineq * (res_vx @ ws.Pdot))
        lamda_y = (lamda_y - pj.rho_ineq * (res_ay @ ws.Pddot)
                   - pj.rho_ineq * (res_vy @ ws.Pdot)
                   - pj.rho_lane * (res_lane @ ws.A_lane))
        out = (c_x, c_y, x, y, xdot, ydot, xddot, yddot, res_norm)

    return ProjectionResult(*out, lamda_x, lamda_y, s_lane)
