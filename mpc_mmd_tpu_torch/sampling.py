"""Outer-CEM parameter sampling, scalar cost and distribution update.

Counterpart of ``clip_v_params``, ``sample_params``, ``initial_params``,
``scalar_cost`` and ``cem_update`` in ``mpc_mmd_tpu/sampling.py``.  The
8-D behavioural parameter is [v_des_1..4, y_des_1..4].  Draws come in as
standard normals ``z`` (see ``noise.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import ProblemConfig


def clip_v_params(params: torch.Tensor, v_min: float, v_max: float) -> torch.Tensor:
    """Clip the 4 desired-velocity columns; offsets stay free."""
    v = torch.clamp(params[:, 0:4], v_min, v_max)
    return torch.cat((v, params[:, 4:]), dim=1)


def sample_params(z: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor,
                  cfg: ProblemConfig) -> torch.Tensor:
    """mean + z @ chol(cov)^T, velocity-clipped; z (n, 8) standard normal.

    ``cholesky_ex`` does not synchronise with the device; like
    ``jax.random.multivariate_normal``, a covariance that is not positive
    definite gives a meaningless factor rather than an error.
    """
    factor = torch.linalg.cholesky_ex(cov).L
    samples = mean + z @ factor.T
    return clip_v_params(samples, cfg.vehicle.v_min, cfg.vehicle.v_max)


def initial_params(cfg: ProblemConfig, mean: torch.Tensor, cov: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Initial batch (num_batch, 8) from the solver's fixed draw ``z``."""
    return sample_params(z, mean, cov, cfg)


def scalar_cost(cfg: ProblemConfig, risk_obs: torch.Tensor, risk_lane: torch.Tensor,
                y: torch.Tensor, res_norm: torch.Tensor,
                xdot: torch.Tensor, ydot: torch.Tensor,
                xddot: torch.Tensor, yddot: torch.Tensor,
                steering: torch.Tensor, v_des) -> torch.Tensor:
    """Per-candidate trajectory quality plus weighted risk."""
    norm = torch.linalg.vector_norm
    steering_vel = torch.diff(steering, dim=1)
    steering_acc = torch.diff(steering_vel, dim=1)
    v = torch.sqrt(xdot ** 2 + ydot ** 2)

    cost_steering = norm(steering, dim=1)
    cost_steering_vel = norm(steering_vel, dim=1)
    cost_steering_acc = norm(steering_acc, dim=1)
    cost_steer_pen = norm(
        torch.clamp(torch.abs(steering) - cfg.vehicle.steer_max, min=0.0), dim=1)
    cost_steer_vel_pen = norm(
        torch.clamp(torch.abs(steering_vel) - 0.05, min=0.0), dim=1)

    return (res_norm
            + 0.1 * norm(v - v_des, dim=1)
            + 0.1 * (cost_steering + cost_steering_vel + cost_steering_acc)
            + 0.1 * (cost_steer_pen + cost_steer_vel_pen)
            + 0.02 * norm(yddot, dim=1)
            + 0.02 * norm(xddot, dim=1)
            + risk_obs + 0.0 * risk_lane)


def cem_update(cfg: ProblemConfig, z: torch.Tensor, params_elite: torch.Tensor,
               cost_elite: torch.Tensor, mean_prev: torch.Tensor,
               cov_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exponentially weighted mean/cov EMA update and resample.

    z: (num_batch - ellite_num, 8) standard normal.  Returns
    (mean, cov, next_params) with next_params = [elites; resampled].
    """
    c = cfg.cem
    w = torch.exp(-(cost_elite - torch.min(cost_elite)) / c.lamda)
    sum_w = torch.sum(w)
    mean = (1.0 - c.alpha_mean) * mean_prev + c.alpha_mean * (
        torch.sum(params_elite * w[:, None], dim=0) / sum_w)
    diffs = params_elite - mean
    cov_w = torch.einsum("b,bi,bj->ij", w, diffs, diffs) / sum_w
    eye = torch.eye(c.num_params, dtype=cov_prev.dtype, device=cov_prev.device)
    cov = ((1.0 - c.alpha_cov) * cov_prev + c.alpha_cov * cov_w
           + c.cov_jitter * eye)
    fresh = sample_params(z, mean, cov, cfg)
    return mean, cov, torch.cat((params_elite, fresh), dim=0)
