# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/outer_tail.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""Kernel (e)'s stage: an outer iteration's step from the reduced sets to
the next parameters (the JAX package's ``mpc_mmd_tpu/solver.py:235-300``,
``solver_frenet.py:199-257``): the MMD obstacle risk of every candidate,
the sort by risk, the lane risks and the scalar cost of the
``ellite_num_cost`` kept, the sort by cost, ``cem_update`` and the best
candidate (:func:`candidates`, ``risk.obstacle_risk``, then
``sampling.cem_tail`` with ``sampling.candidate_cost``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import risk, sampling
from .config import ProblemConfig
from .outer_project import OuterProjection


class TailResult(NamedTuple):
    """The next CEM moments and parameters, and the reference's pick."""

    mean: torch.Tensor       # (N, 8)
    cov: torch.Tensor        # (N, 8, 8)
    params: torch.Tensor     # (N, nb, 8): the elites, then the resample
    best: torch.Tensor       # (N,) int64: the pick's position in residual order
    risk_obs: torch.Tensor   # (N,) its obstacle risk
    risk_lane: torch.Tensor  # (N,) its lane risk (unweighted)
    kept: torch.Tensor       # (N, n_cost) int64: the kept candidates' positions
    elites: torch.Tensor     # (N, ellite_num) int64: the elites' indices in kept


_ROWS = ("y", "xdot", "ydot", "xddot", "yddot", "res_norm")


def candidates(pj: OuterProjection, order: torch.Tensor, params: torch.Tensor,
               frenet: bool):
    """The candidates' values the scalar cost reads, {name: (N, nb, ...)} in
    the residual order ``order`` (N, nb): the projection's rows, "steer"
    (the Frenet steering on the road, else the controls' steer), on the
    road "kappa", and "params" from params (N, nb, 8) by projection row."""
    N, nb = order.shape
    per = torch.arange(N, device=order.device)[:, None]
    in_order = lambda t: t.reshape(N, nb, *t.shape[1:])[per, order]
    cand = {name: in_order(getattr(pj, name)) for name in _ROWS}
    cand["steer"] = in_order(pj.steering if frenet else pj.steer)
    if frenet:
        cand["kappa"] = in_order(pj.kappa_interp)
    cand["params"] = params[per, order]
    return cand


def outer_tail(cfg: ProblemConfig, frenet: bool, pj: OuterProjection,
               order: torch.Tensor, params: torch.Tensor, beta: torch.Tensor,
               sigma: torch.Tensor, x_roll: torch.Tensor, y_roll: torch.Tensor,
               x_obs: torch.Tensor, y_obs: torch.Tensor, z: torch.Tensor,
               mean: torch.Tensor, cov: torch.Tensor, v_des: torch.Tensor,
               res: torch.Tensor, res_2: torch.Tensor, it: int) -> TailResult:
    """The step of outer iteration ``it`` of a chunk of N scenarios: pj the
    iteration's :class:`OuterProjection` (rows N nb), order (N, nb) its
    stable sort by residual, params (N, nb, 8) by projection row, beta (N,
    nb, R), sigma (N, nb), x_roll, y_roll (N, nb, R, T) the reduced sets in
    residual order, x_obs, y_obs (N, num_obs, num), z the resample's
    normals, mean (N, 8), cov (N, 8, 8), v_des a 0-d tensor; writes
    res[:, it] (the best cost) and res_2[:, it] (its projection
    residual)."""
    cand = candidates(pj, order, params, frenet)
    risk_obs = risk.obstacle_risk(cfg, beta, sigma, x_roll, y_roll, x_obs, y_obs)
    cand.update(roll=y_roll, beta=beta, sigma=sigma)
    N = risk_obs.shape[0]
    mean, cov, params, kept, least, idx_min, elites = sampling.cem_tail(
        cfg, risk_obs, cand, lambda k: sampling.candidate_cost(cfg, k, v_des, frenet),
        z, mean, cov)
    n = torch.arange(N, device=risk_obs.device)
    res[:, it] = least
    res_2[:, it] = kept["res_norm"][n, idx_min]
    return TailResult(mean, cov, params, kept["pos"][n, idx_min],
                      kept["risk_obs"][n, idx_min], kept["risk_lane"][n, idx_min],
                      kept["pos"], elites)
