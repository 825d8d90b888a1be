# Frozen copy of mpc_mmd_tpu_torch/sampling.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Outer-CEM parameter sampling, scalar cost and distribution update.

Counterpart of ``clip_v_params``, ``sample_params``, ``initial_params``,
``scalar_cost``, ``cem_update`` and ``gmm_noisy_init_state`` in
``mpc_mmd_tpu/sampling.py`` and of ``_frenet_scalar_cost`` in
``mpc_mmd_tpu/solver_frenet.py``.  The 8-D behavioural parameter is
[v_des_1..4, y_des_1..4].  Draws come in as standard normals ``z`` (see
``noise.py``).  ``scalar_cost`` and ``cem_update`` take any leading batch:
a chunk of scenarios gives each its own weights, moments and (N, 8, 8)
covariance.  :func:`cem_tail` is the outer CEM's step from the candidates'
obstacle risks to the next parameters, shared by both solvers; in
``mmd_opt`` kernel (e) (``ops/outer_tail.py``) runs it in one launch, with
the bits of these operations on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import risk as risk_mod
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
    the device.  On the card ``cholesky_ex`` runs cuSOLVER's batched potrf,
    whose arithmetic kernel (e) repeats (``csrc/outer_tail.cu``).
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


def frenet_scalar_cost(cfg: ProblemConfig, risk_des_lane, risk_obs, risk_lane,
                       y, res_norm, xdot, ydot, xddot, yddot, steering,
                       kappa_interp, v_des):
    """The on-road cost: the straight-road trajectory cost with its risks
    zeroed, plus the weighted product of the distances to the two lane
    centres and the centripetal penalty, plus the (pre-weighted) risks."""
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


def candidate_cost(cfg: ProblemConfig, k: Dict[str, torch.Tensor], v_des,
                   frenet: bool) -> torch.Tensor:
    """The scalar cost (N, n) of the candidates kept by risk, from their
    values ``k`` {name: (N, n, ...)}: the lane risk of the mode (and on the
    road the weighted desired-lane risk), which it adds to ``k`` as
    "risk_lane" (and "risk_des"), then the straight-road or on-road cost.
    ``k`` holds "risk_obs", "roll", "beta", "sigma", "y", "res_norm",
    "xdot", "ydot", "xddot", "yddot", "steer" and, on the road, "kappa"."""
    w_lane, w_obs = cfg.risk.weights()
    k["risk_lane"], k["risk_des"] = risk_mod.lane_risks(
        cfg, k["beta"], k["sigma"], k["roll"], frenet)
    if not frenet:
        return scalar_cost(cfg, w_obs * k["risk_obs"], w_lane * k["risk_lane"],
                           k["y"], k["res_norm"], k["xdot"], k["ydot"],
                           k["xddot"], k["yddot"], k["steer"], v_des)
    return frenet_scalar_cost(cfg, k["risk_des"], w_obs * k["risk_obs"],
                              w_lane * k["risk_lane"], k["y"], k["res_norm"],
                              k["xdot"], k["ydot"], k["xddot"], k["yddot"],
                              k["steer"], k["kappa"], v_des)


def cem_tail(cfg: ProblemConfig, risk_obs: torch.Tensor,
             cand: Dict[str, torch.Tensor],
             cost: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
             z: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor):
    """The outer CEM's step from the obstacle risks (N, nb) of a chunk's
    candidates to the next parameters, every sort a stable argsort.

    ``cand`` {name: (N, nb, ...)} holds the candidates' values ("params"
    among them); ``cost(kept)`` the scalar cost (N, n_cost) of the
    ``ellite_num_cost`` kept by least risk, from their values (to which it
    may add); the ``ellite_num`` least costs are the elites of
    :func:`cem_update` on ``z``.  Returns (mean, cov, params, kept, res,
    idx_min, elites): ``kept`` the kept candidates' values with "pos" their
    positions in ``cand``, res (N,) the least elite cost, idx_min (N,) the
    reference's pick among the kept, the argmin over the SORTED elite costs
    (so 0, or the first NaN) applied to the risk-sorted arrays, and elites
    (N, ellite_num) the elites' indices among the kept.
    """
    c = cfg.cem
    N, nb = risk_obs.shape
    per = torch.arange(N, device=risk_obs.device)[:, None]
    pos = torch.arange(nb, device=risk_obs.device).expand(N, nb)
    order2 = torch.argsort(risk_obs, dim=1, stable=True)[:, :c.ellite_num_cost]
    kept = {name: t[per, order2] for name, t in (
        ("risk_obs", risk_obs), ("pos", pos), *cand.items())}
    cost_batch = cost(kept)
    elite_idx = torch.argsort(cost_batch, dim=1, stable=True)[:, :c.ellite_num]
    cost_elite = torch.gather(cost_batch, 1, elite_idx)
    mean, cov, params = cem_update(cfg, z, kept["params"][per, elite_idx],
                                   cost_elite, mean, cov)
    idx_min = torch.argmin(cost_elite, dim=1)
    return mean, cov, params, kept, torch.amin(cost_elite, dim=1), idx_min, elite_idx


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


