"""Risk costs over rollout ensembles: MMD, CVaR and SAA.

Counterpart of ``f_bar_obs``, ``lane_bars``, ``cvar_reduce``,
``saa_reduce``, ``lane_des_bar`` and the ``{mmd,cvar,saa}_{obs,lane,
lane_des}`` risks in ``mpc_mmd_tpu/risk.py``.  The JAX functions take one candidate and are
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


def cvar_reduce(samples: torch.Tensor, alpha: float) -> torch.Tensor:
    """Mean of the samples at or above their alpha-quantile, (..., R) -> (...).

    The quantile interpolates linearly, as ``jnp.quantile`` does; the mask
    is ``>=``, so an all-zero row gives 0.
    """
    var_alpha = torch.quantile(samples, alpha, dim=-1, keepdim=True,
                               interpolation="linear")
    mask = samples >= var_alpha
    n = torch.sum(mask, dim=-1)
    s = torch.sum(torch.where(mask, samples, torch.zeros_like(samples)), dim=-1)
    return torch.where(n > 0, s / torch.clamp(n, min=1), torch.zeros_like(s))


def saa_reduce(samples: torch.Tensor, num_reduced: int) -> torch.Tensor:
    """Fraction of violating samples, normalised by num_reduced as in the
    reference (also for the lane's two-sided sum)."""
    return torch.sum((samples > 0.0).to(samples.dtype), dim=-1) / num_reduced


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


def cvar_obs(cfg: ProblemConfig, x_roll: torch.Tensor, y_roll: torch.Tensor,
             x_obs: torch.Tensor, y_obs: torch.Tensor) -> torch.Tensor:
    return cvar_reduce(f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs),
                       cfg.risk.alpha_quant)


def cvar_lane(cfg: ProblemConfig, y_roll: torch.Tensor) -> torch.Tensor:
    lb, ub = lane_bars(cfg, y_roll)
    return (cvar_reduce(lb, cfg.risk.alpha_quant)
            + cvar_reduce(ub, cfg.risk.alpha_quant))


def saa_obs(cfg: ProblemConfig, x_roll: torch.Tensor, y_roll: torch.Tensor,
            x_obs: torch.Tensor, y_obs: torch.Tensor) -> torch.Tensor:
    return saa_reduce(f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs),
                      cfg.risk.num_reduced)


def saa_lane(cfg: ProblemConfig, y_roll: torch.Tensor) -> torch.Tensor:
    lb, ub = lane_bars(cfg, y_roll)
    return (saa_reduce(lb, cfg.risk.num_reduced)
            + saa_reduce(ub, cfg.risk.num_reduced))


def lane_des_bar(cfg: ProblemConfig, y_roll: torch.Tensor) -> torch.Tensor:
    """Desired-lane violation (..., R) of rollouts (..., R, T), in the
    reference's form: the product of the Frobenius distances of each
    candidate's whole (R, T) block to the two lane centres, minus the
    margin, floored at 0 (so the same value for every rollout)."""
    norm = lambda t: torch.linalg.vector_norm(t, dim=(-2, -1))
    cost = (norm(y_roll - cfg.lane.y_des_1) * norm(y_roll - cfg.lane.y_des_2)
            - cfg.lane.gamma_lane_des)
    return torch.clamp(cost, min=0.0)[..., None].expand(y_roll.shape[:-1])


def mmd_lane_des(cfg: ProblemConfig, beta: torch.Tensor, sigma: torch.Tensor,
                 y_roll: torch.Tensor) -> torch.Tensor:
    return mmd_vs_zero(beta, lane_des_bar(cfg, y_roll), sigma, cfg.risk.ker_wt,
                       kind=cfg.risk.kernel)


def cvar_lane_des(cfg: ProblemConfig, y_roll: torch.Tensor) -> torch.Tensor:
    return cvar_reduce(lane_des_bar(cfg, y_roll), cfg.risk.alpha_quant_lane)


def saa_lane_des(cfg: ProblemConfig, y_roll: torch.Tensor) -> torch.Tensor:
    return saa_reduce(lane_des_bar(cfg, y_roll), cfg.risk.num_reduced)
