# Frozen copy of mpc_mmd_tpu_torch/projection.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Alternating-minimisation feasibility projection.

Counterpart of ``project`` in ``mpc_mmd_tpu/projection.py``.  Each AM round
is two products with the prefactored KKT inverses plus elementwise
trigonometry; every product is ``linalg.scenario_mm``, so a candidate's
bits do not depend on how many scenarios' rows a chunk gives the
projection.  The stochastic variant (every risk-aware mode) leaves the
obstacles to the risk cost; the obstacle-active one
(``ProjectionConfig.with_obstacle_terms``, the ``det`` baseline) is the
port's.  Given the path's
``arc_vec`` and ``kappa`` (the Frenet solve), the result also carries the
curvature-coupled steering and the path curvature under each candidate.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import ProblemConfig
from .frenet import interp
from .linalg import scenario_mm
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
    steering: torch.Tensor   # (batch, num) Frenet steering (zeros off the path)
    kappa_interp: torch.Tensor  # (batch, num) path curvature at x (zeros off it)


def unwrap(p: torch.Tensor) -> torch.Tensor:
    """``jnp.unwrap(p, axis=-1)`` with period 2 pi, written out in torch.

    Adds multiples of 2 pi wherever a step exceeds pi, with the same
    boundary rule as numpy and JAX: a step of exactly +pi stays +pi.  The
    constants are the float32 2 pi and pi as Python floats (a tensor made
    on the card from the host would be a blocking copy).
    """
    period = float(np.float32(2.0 * math.pi))
    interval = float(np.float32(2.0 * math.pi) / 2)
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
            s_lane: torch.Tensor,
            x_obs: Optional[torch.Tensor] = None,
            y_obs: Optional[torch.Tensor] = None,
            arc_vec: Optional[torch.Tensor] = None,
            kappa: Optional[torch.Tensor] = None) -> ProjectionResult:
    """Project guess coefficients onto the feasible set (AM iterations).

    One polar initialisation with the multiplier pre-update, then
    ``projection.maxiter`` rounds of QP solve, polar re-estimate and
    multiplier update.  Multipliers and lane slack are warm-started across
    outer CEM iterations by the caller.  x_obs, y_obs (num_obs, num), or
    (N, num_obs, num) when the rows are the candidates of N scenarios one
    after another, set the products' ``scenarios``.  The KKT
    systems are solved by their prefactored inverses.  With ``arc_vec`` and ``kappa``
    (the path, in the Frenet solve) the result carries the steering
    ``atan((kappa_f + kappa cos(a_v) / (1 - y kappa)) L)``, with kappa the
    path curvature at the candidate's arc length x (clipped to the path)
    and kappa_f = d_a sin(a_a - a_v) / d_v^2 the trajectory's own.
    """
    pj, veh, lane = cfg.projection, cfg.vehicle, cfg.lane
    if pj.with_obstacle_terms:
        raise NotImplementedError("the reference has no obstacle-active projection "
                                  "(with_obstacle_terms is off in the cells)")
    if pj.maxiter < 1:
        raise ValueError("projection.maxiter must be at least 1")
    nvar = cfg.horizon.nvar
    num = cfg.horizon.num
    n = 1 if x_obs is None or x_obs.dim() == 2 else x_obs.shape[0]
    mm = lambda a, w: scenario_mm(a, w, n)

    xdot_g = mm(c_x_bar, ws.Pdot.T)
    ydot_g = mm(c_y_bar, ws.Pdot.T)
    xddot_g = mm(c_x_bar, ws.Pddot.T)
    yddot_g = mm(c_y_bar, ws.Pddot.T)

    alpha_v, d_v = _polar_clip(xdot_g, ydot_g, pj.rho_ineq,
                               veh.v_min, veh.v_max, unwrap_angle=True)
    alpha_a, d_a = _polar_clip(xddot_g, yddot_g, pj.rho_ineq,
                               0.0, veh.a_max, unwrap_angle=True)

    res_vx = xdot_g - d_v * torch.cos(alpha_v)
    res_vy = ydot_g - d_v * torch.sin(alpha_v)
    res_ax = xddot_g - d_a * torch.cos(alpha_a)
    res_ay = yddot_g - d_a * torch.sin(alpha_a)

    lamda_x = lamda_x - pj.rho_ineq * mm(res_ax, ws.Pddot) - pj.rho_ineq * mm(res_vx, ws.Pdot)
    lamda_y = lamda_y - pj.rho_ineq * mm(res_ay, ws.Pddot) - pj.rho_ineq * mm(res_vy, ws.Pdot)

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
                     - pj.rho_ineq * mm(b_ax, ws.Pddot)
                     - pj.rho_ineq * mm(b_vx, ws.Pdot))
        lincost_y = (-lamda_y - pj.rho_projection * c_y_bar
                     - pj.rho_ineq * mm(b_ay, ws.Pddot)
                     - pj.rho_ineq * mm(b_vy, ws.Pdot)
                     - pj.rho_lane * mm(b_lane_aug, ws.A_lane))
        sol_x = kkt_solve(ws.proj_kkt_x_inv, torch.cat((-lincost_x, b_eq_x), dim=1), n)
        sol_y = kkt_solve(ws.proj_kkt_y_inv, torch.cat((-lincost_y, b_eq_y), dim=1), n)
        c_x = sol_x[:, :nvar]
        c_y = sol_y[:, :nvar]

        x = mm(c_x, ws.P.T)
        y = mm(c_y, ws.P.T)
        xdot = mm(c_x, ws.Pdot.T)
        ydot = mm(c_y, ws.Pdot.T)
        xddot = mm(c_x, ws.Pddot.T)
        yddot = mm(c_y, ws.Pddot.T)

        lane_val = mm(c_y, ws.A_lane.T)
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

        lamda_x = (lamda_x - pj.rho_ineq * mm(res_ax, ws.Pddot)
                   - pj.rho_ineq * mm(res_vx, ws.Pdot))
        lamda_y = (lamda_y - pj.rho_ineq * mm(res_ay, ws.Pddot)
                   - pj.rho_ineq * mm(res_vy, ws.Pdot)
                   - pj.rho_lane * mm(res_lane, ws.A_lane))

    if arc_vec is not None:
        x_on_path = torch.minimum(torch.clamp(x, min=0.0), arc_vec[-1])
        kappa_interp = interp(x_on_path.reshape(-1), arc_vec, kappa).reshape(x.shape)
        kappa_frenet = d_a * torch.sin(alpha_a - alpha_v) / (d_v ** 2)
        steering = torch.atan(
            (kappa_frenet + kappa_interp * torch.cos(alpha_v)
             / (1.0 - y * kappa_interp)) * veh.wheel_base)
    else:
        kappa_interp = torch.zeros_like(x)
        steering = torch.zeros_like(x)

    return ProjectionResult(c_x, c_y, x, y, xdot, ydot, xddot, yddot, res_norm,
                            lamda_x, lamda_y, s_lane, steering, kappa_interp)
