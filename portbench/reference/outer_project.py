# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/outer_project.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""Kernel (d)'s stage: the guess QP, the AM projection and the controls of
every candidate row (``qp.compute_guess``, ``projection.project``,
``dynamics.controls_from_trajectory``), the JAX package's
``mpc_mmd_tpu/solver.py:190-200``.  The rows are independent: the
controls of a row computed before the outer loop's sort by residual are
the ones it has after it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import dynamics, projection, qp
from .config import ProblemConfig
from .qp import Workspace


class OuterProjection(NamedTuple):
    """The projection's fields (``projection.ProjectionResult``) and the
    controls of each row."""

    c_x: torch.Tensor        # (rows, nvar)
    c_y: torch.Tensor
    x: torch.Tensor          # (rows, num)
    y: torch.Tensor
    xdot: torch.Tensor
    ydot: torch.Tensor
    xddot: torch.Tensor
    yddot: torch.Tensor
    res_norm: torch.Tensor   # (rows,)
    lamda_x: torch.Tensor    # (rows, nvar)
    lamda_y: torch.Tensor
    s_lane: torch.Tensor     # (rows, 2 (num - 1))
    steering: torch.Tensor   # (rows, num) Frenet steering (zeros off the path)
    kappa_interp: torch.Tensor  # (rows, num)
    acc: torch.Tensor        # (rows, num) controls_from_trajectory's
    steer: torch.Tensor


def outer_project(cfg: ProblemConfig, ws: Workspace, params: torch.Tensor,
                  b_eq_x: torch.Tensor, b_eq_y: torch.Tensor,
                  lamda_x: torch.Tensor, lamda_y: torch.Tensor,
                  s_lane: torch.Tensor, x_obs: Optional[torch.Tensor] = None,
                  y_obs: Optional[torch.Tensor] = None,
                  arc_vec: Optional[torch.Tensor] = None,
                  kappa: Optional[torch.Tensor] = None) -> OuterProjection:
    """The guess QP, the projection and the controls of the rows ``params``
    (N nb, 8), scenario after scenario; x_obs, y_obs (N, num_obs, num) set
    the scenarios; ``arc_vec`` and ``kappa`` the path (on the road)."""
    scenarios = 1 if x_obs is None or x_obs.dim() == 2 else x_obs.shape[0]
    cx_bar, cy_bar = qp.compute_guess(cfg, ws, params, b_eq_x, b_eq_y, scenarios)
    pr = projection.project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y, lamda_x,
                            lamda_y, s_lane, x_obs, y_obs, arc_vec, kappa)
    acc, steer = dynamics.controls_from_trajectory(
        pr.xdot, pr.ydot, pr.xddot, pr.yddot, cfg.horizon.dt, cfg.vehicle.wheel_base)
    return OuterProjection(*pr, acc, steer)