# Frozen copy of mpc_mmd_tpu_torch/risk.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Risk costs over rollout ensembles: the MMD risks of ``mmd_opt``.

Counterpart of ``f_bar_obs``, ``lane_bars``, ``mmd_obs`` and ``mmd_lane``
in ``mpc_mmd_tpu/risk.py`` (the CVaR, SAA and desired-lane risks are the
port's).  The JAX functions take one candidate and are
vmapped; these take any leading batch of candidates, (C, ...) or, for a
chunk of N scenarios, (N, C, ...).
"""

from __future__ import annotations

import torch

from .config import ProblemConfig
from .kernels import mmd_vs_zero


def f_bar_obs(cfg: ProblemConfig, x_roll: torch.Tensor, y_roll: torch.Tensor,
              x_obs: torch.Tensor, y_obs: torch.Tensor) -> torch.Tensor:
    """Elliptical obstacle violation, max over time and obstacles.

    x_roll, y_roll: (..., R, T); x_obs, y_obs: (..., num_obs, T), their
    leading dims broadcast against the rollouts' (so (num_obs, T) for every
    candidate, or (N, 1, num_obs, T) against a chunk's (N, C, R, T)).
    Returns (..., R).
    """
    dx = x_roll[..., :, None, :] - x_obs[..., None, :, :]
    dy = y_roll[..., :, None, :] - y_obs[..., None, :, :]
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


def obstacle_risk(cfg: ProblemConfig, beta, sigma, x_roll: torch.Tensor,
                  y_roll: torch.Tensor, x_obs: torch.Tensor, y_obs: torch.Tensor):
    """The obstacle risk (N, nb) of the candidates' rollouts (N, nb, R, T)
    against the obstacles (N, num_obs, >= T): the MMD with beta (N, nb, R)
    and sigma (N, nb)."""
    T = x_roll.shape[-1]
    return mmd_obs(cfg, beta, sigma, x_roll, y_roll, x_obs[:, None, :, :T],
                   y_obs[:, None, :, :T])


def mmd_lane(cfg: ProblemConfig, beta: torch.Tensor, sigma: torch.Tensor,
             y_roll: torch.Tensor) -> torch.Tensor:
    lb, ub = lane_bars(cfg, y_roll)
    return (mmd_vs_zero(beta, lb, sigma, cfg.risk.ker_wt, kind=cfg.risk.kernel)
            + mmd_vs_zero(beta, ub, sigma, cfg.risk.ker_wt, kind=cfg.risk.kernel))


def lane_risks(cfg: ProblemConfig, beta: torch.Tensor, sigma: torch.Tensor,
               roll: torch.Tensor, frenet: bool):
    """(lane risk, weighted desired-lane risk) of candidates (..., ) from
    their rollouts' lateral positions ``roll`` (..., R, T), beta (..., R)
    and sigma (...): the MMD lane risk, and a desired-lane risk of 0 (its
    weight is 0 in the cells)."""
    if frenet and cfg.risk.weight_lane_des != 0.0:
        raise NotImplementedError("the reference has no desired-lane risk "
                                  "(weight_lane_des is 0 in the cells)")
    return mmd_lane(cfg, beta, sigma, roll), torch.zeros(sigma.shape, device=sigma.device)
