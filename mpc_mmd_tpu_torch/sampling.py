"""Outer-CEM parameter sampling, scalar cost and distribution update.

Counterpart of ``clip_v_params``, ``sample_params``, ``initial_params``,
``scalar_cost``, ``cem_update`` and ``gmm_noisy_init_state`` in
``mpc_mmd_tpu/sampling.py``.  The 8-D behavioural parameter is
[v_des_1..4, y_des_1..4].  Draws come in as standard normals ``z`` (see
``noise.py``).  ``scalar_cost`` and ``cem_update`` take any leading batch:
a chunk of scenarios gives each its own weights, moments and (N, 8, 8)
covariance.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import ProblemConfig
from .linalg import matmul_rows


def clip_v_params(params: torch.Tensor, v_min: float, v_max: float) -> torch.Tensor:
    """Clip the 4 desired-velocity columns; offsets stay free."""
    v = torch.clamp(params[..., 0:4], v_min, v_max)
    return torch.cat((v, params[..., 4:]), dim=-1)


def _cholesky(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of covariances (..., n, n), NaN where one is
    not positive definite (as ``jax.random.multivariate_normal`` gives).

    ``cholesky_ex`` runs one algorithm on a single matrix and a batched one
    on several, with other bits, so the batch always gets one identity
    matrix more: a scenario's factor is then the same alone and in a chunk
    (checked on the H100 at 1 to 8 matrices).  It does not synchronise with
    the device.
    """
    flat = cov.reshape(-1, *cov.shape[-2:])
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    L, info = torch.linalg.cholesky_ex(torch.cat((flat, eye[None])))
    L = torch.where((info[:-1] == 0)[:, None, None], L[:-1], torch.nan)
    return L.reshape(cov.shape)


def sample_params(z: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor,
                  cfg: ProblemConfig) -> torch.Tensor:
    """mean + z @ chol(cov)^T, velocity-clipped; z (..., n, 8) standard
    normal, mean (..., 8), cov (..., 8, 8).

    The product is ``linalg.matmul_rows``, whose bits do not depend on the
    number of scenarios.  A covariance that is not positive definite gives
    NaN rather than an error.
    """
    factor = _cholesky(cov)
    samples = mean[..., None, :] + matmul_rows(z, factor.mT[..., None, :, :])
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
    """Per-candidate trajectory quality plus weighted risk; trajectories
    (..., num), risks and residuals (...)."""
    norm = torch.linalg.vector_norm
    steering_vel = torch.diff(steering, dim=-1)
    steering_acc = torch.diff(steering_vel, dim=-1)
    v = torch.sqrt(xdot ** 2 + ydot ** 2)

    cost_steering = norm(steering, dim=-1)
    cost_steering_vel = norm(steering_vel, dim=-1)
    cost_steering_acc = norm(steering_acc, dim=-1)
    cost_steer_pen = norm(
        torch.clamp(torch.abs(steering) - cfg.vehicle.steer_max, min=0.0), dim=-1)
    cost_steer_vel_pen = norm(
        torch.clamp(torch.abs(steering_vel) - 0.05, min=0.0), dim=-1)

    return (res_norm
            + 0.1 * norm(v - v_des, dim=-1)
            + 0.1 * (cost_steering + cost_steering_vel + cost_steering_acc)
            + 0.1 * (cost_steer_pen + cost_steer_vel_pen)
            + 0.02 * norm(yddot, dim=-1)
            + 0.02 * norm(xddot, dim=-1)
            + risk_obs + 0.0 * risk_lane)


def cem_update(cfg: ProblemConfig, z: torch.Tensor, params_elite: torch.Tensor,
               cost_elite: torch.Tensor, mean_prev: torch.Tensor,
               cov_prev: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exponentially weighted mean/cov EMA update and resample.

    params_elite (..., n_el, 8), cost_elite (..., n_el), mean_prev (..., 8),
    cov_prev (..., 8, 8); z: (..., num_batch - ellite_num, 8) standard
    normal.  Returns (mean, cov, next_params) with next_params = [elites;
    resampled].
    """
    c = cfg.cem
    w = torch.exp(-(cost_elite - torch.amin(cost_elite, dim=-1, keepdim=True))
                  / c.lamda)
    sum_w = torch.sum(w, dim=-1)
    mean = (1.0 - c.alpha_mean) * mean_prev + c.alpha_mean * (
        torch.sum(params_elite * w[..., None], dim=-2) / sum_w[..., None])
    diffs = params_elite - mean[..., None, :]
    cov_w = (matmul_rows((w[..., :, None] * diffs).mT, diffs[..., None, :, :])
             / sum_w[..., None, None])
    eye = torch.eye(c.num_params, dtype=cov_prev.dtype, device=cov_prev.device)
    cov = ((1.0 - c.alpha_cov) * cov_prev + c.alpha_cov * cov_w
           + c.cov_jitter * eye)
    fresh = sample_params(z, mean, cov, cfg)
    return mean, cov, torch.cat((params_elite, fresh), dim=-2)


# The 3-mode position GMM of the reference's synthetic workloads
# (mpc_mmd_tpu/sampling.py:116-122), which no solve path of either package
# calls.
GMM_INIT_PROBS = (0.4, 0.2, 0.4)
GMM_INIT_MU = ((0.5, 0.0, 0.5, 0.0),
               (0.5, -0.1, 0.9, 0.01),
               (-0.2, 0.1, 1.0, -0.015))
GMM_INIT_SIGMA = ((0.1, 0.1, 1.0, 0.1),
                  (0.02, 0.01, 0.8, 0.05),
                  (0.1, 0.01, 0.1, 0.01))


def gmm_noisy_init_state(z: torch.Tensor, modes: torch.Tensor, x_init, y_init,
                         vx_init, vy_init, probs=GMM_INIT_PROBS, mu=GMM_INIT_MU,
                         sigma=GMM_INIT_SIGMA):
    """n perturbed initial states from the 3-mode position GMM.

    ``z`` (n, 4) standard normals and ``modes`` (n,) the mode (1, 2 or 3)
    of each member, from a noise source's ``gmm_init_draws``; the JAX
    package draws both from one key.  Mode m takes the first
    ``int(p_m n)`` members that chose it (mode 1 absorbs the remainder),
    and where fewer chose it, the rest of its share repeats member 0 (the
    zero fill of ``jnp.where(..., size=)``).  Only x and y move: the v and
    psi perturbations are multiplied by 0, as in the reference.  Returns
    (x, y, vx, vy, psi), each (n,).  Nothing synchronises with the device.
    """
    n = z.shape[0]
    dev, dt = z.device, z.dtype
    mu_a = torch.tensor(mu, dtype=dt, device=dev)            # (3, 4)
    sigma_a = torch.tensor(sigma, dtype=dt, device=dev)
    sizes = [int(float(p) * n) for p in probs]
    sizes[0] = n - (sizes[1] + sizes[2])
    per_mode = z[None] * sigma_a[:, None, :] + mu_a[:, None, :]   # (3, n, 4)
    members = torch.arange(n, device=dev)
    parts = []
    for m in range(3):
        chose = modes == m + 1
        rank = torch.cumsum(chose.to(torch.int64), 0) - 1
        # member i goes to slot rank[i] if it chose m and the slot exists;
        # every other member to a spare slot past the share
        slot = torch.where(chose & (rank < sizes[m]), rank,
                           torch.full_like(rank, sizes[m]))
        pick = torch.zeros(sizes[m] + 1, dtype=torch.int64, device=dev)
        pick.scatter_(0, slot, members)
        parts.append(per_mode[m][pick[:sizes[m]]])
    eps = torch.cat(parts, dim=0)
    v_init = torch.sqrt(vx_init ** 2 + vy_init ** 2)
    psi_init = torch.atan2(vy_init, vx_init)
    x = x_init + eps[:, 0]
    y = y_init + eps[:, 1]
    v = v_init + 0.0 * eps[:, 2]
    psi = psi_init + 0.0 * eps[:, 3]
    return x, y, v * torch.cos(psi), v * torch.sin(psi), psi
