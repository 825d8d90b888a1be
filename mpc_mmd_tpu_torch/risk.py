"""MMD risk over reduced rollout sets.

Counterpart of ``f_bar_obs``, ``lane_bars``, ``mmd_obs`` and ``mmd_lane`` in
``mpc_mmd_tpu/risk.py``.  The JAX functions take one candidate and are
vmapped; these take any leading batch of candidates.
"""

from __future__ import annotations

import torch

from .config import ProblemConfig
from .kernels import mmd_vs_zero


def f_bar_obs(cfg: ProblemConfig, x_roll: torch.Tensor, y_roll: torch.Tensor,
              x_obs: torch.Tensor, y_obs: torch.Tensor) -> torch.Tensor:
    """Elliptical obstacle violation, max over time and obstacles.

    x_roll, y_roll: (..., R, T); x_obs, y_obs: (num_obs, T).  Returns (..., R).
    """
    dx = x_roll[..., :, None, :] - x_obs
    dy = y_roll[..., :, None, :] - y_obs
    cost = (1.0 - (dx ** 2) / cfg.obstacles.a_obs ** 2
            - (dy ** 2) / cfg.obstacles.b_obs ** 2)
    return torch.clamp(cost, min=0.0).amax(dim=(-2, -1))


def lane_bars(cfg: ProblemConfig, y_roll: torch.Tensor):
    """Lane lower/upper violation, max over time: (..., R) each."""
    lb = torch.clamp(cfg.lane.y_lb - y_roll, min=0.0)
    ub = torch.clamp(y_roll - cfg.lane.y_ub, min=0.0)
    return lb.amax(dim=-1), ub.amax(dim=-1)


def mmd_obs(cfg: ProblemConfig, beta: torch.Tensor, sigma: torch.Tensor,
            x_roll: torch.Tensor, y_roll: torch.Tensor,
            x_obs: torch.Tensor, y_obs: torch.Tensor) -> torch.Tensor:
    """beta (..., R), sigma (...), rollouts (..., R, T) -> (...)."""
    viol = f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs)
    return mmd_vs_zero(beta, viol, sigma, cfg.risk.ker_wt, kind=cfg.risk.kernel)


def mmd_lane(cfg: ProblemConfig, beta: torch.Tensor, sigma: torch.Tensor,
             y_roll: torch.Tensor) -> torch.Tensor:
    lb, ub = lane_bars(cfg, y_roll)
    return (mmd_vs_zero(beta, lb, sigma, cfg.risk.ker_wt, kind=cfg.risk.kernel)
            + mmd_vs_zero(beta, ub, sigma, cfg.risk.ker_wt, kind=cfg.risk.kernel))
