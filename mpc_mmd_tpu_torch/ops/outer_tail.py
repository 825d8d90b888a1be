"""Kernel (e): an outer iteration's step from the reduced sets to the next
parameters, every scenario of a chunk in one launch (CUDA source
``csrc/outer_tail.cu``), and its plain version.

The JAX package runs this part of an outer iteration inside its jitted
``lax.scan`` (``mpc_mmd_tpu/solver.py:235-300``,
``solver_frenet.py:199-257``): the obstacle risk of every candidate, the
sort by risk, the lane risks and the scalar cost of the ``ellite_num_cost``
kept, the sort by cost, ``cem_update`` and the best candidate.
:func:`outer_tail_plain` is the port's chain of PyTorch operations for it
(:func:`candidates`, the mode's risk (``risk.obstacle_risk``), then
:func:`chain_tail`: ``sampling.cem_tail`` with ``sampling.candidate_cost``;
about 150 launches an outer iteration on the card, and the gathers by the
residual order); :func:`outer_tail` runs all of it in one launch, a
thread-block cluster a scenario, in each risk mode (``config.RISK_MODES``:
the MMD with reduced sets, the MMD with uniform weights, CVaR, SAA, and
``det``'s none).

On the card the solvers take the kernel in every mode under the
"prefactored" strategy without a candidate mesh of several ranks
(``solver.SolverSetup._routes``); "exact" and a mesh keep the chain
(:func:`candidates` and :func:`chain_tail` after the mode's risk).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .. import risk, sampling
from ..config import RISK_MODES, ProblemConfig
from .inner_cem import KINDS
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


def chain_tail(cfg: ProblemConfig, frenet: bool, risk_obs: torch.Tensor, cand,
               z: torch.Tensor, mean: torch.Tensor, cov: torch.Tensor,
               v_des: torch.Tensor, res: torch.Tensor, res_2: torch.Tensor,
               it: int) -> TailResult:
    """``sampling.cem_tail`` of the obstacle risks (N, nb) and the
    candidates' values ``cand`` (:func:`candidates` and their reduced sets'
    "roll", "beta", "sigma") with the mode's cost; writes res[:, it] and
    res_2[:, it].  The plain version's tail, and the chain of the modes and
    strategies that kernel (e) does not take."""
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


def filled(cfg: ProblemConfig, lead, device, beta, sigma, x_roll, y_roll):
    """(beta, sigma, x_roll, y_roll) of candidates ``lead`` (N, nb) as the
    chain reads them in every mode: where they are None, the uniform
    weights (``risk.uniform_weights``) and, in ``det``, zero rollouts."""
    if x_roll is None:
        R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
        x_roll = y_roll = torch.zeros(*lead, R, T, device=device)
    if beta is None:
        beta, sigma = risk.uniform_weights(cfg, lead, device)
    return beta, sigma, x_roll, y_roll


def outer_tail_plain(cfg: ProblemConfig, frenet: bool, pj: OuterProjection,
                     order: torch.Tensor, params: torch.Tensor,
                     beta: Optional[torch.Tensor], sigma: Optional[torch.Tensor],
                     x_roll: Optional[torch.Tensor], y_roll: Optional[torch.Tensor],
                     x_obs: torch.Tensor, y_obs: torch.Tensor, z: torch.Tensor,
                     mean: torch.Tensor, cov: torch.Tensor, v_des: torch.Tensor,
                     res: torch.Tensor, res_2: torch.Tensor, it: int) -> TailResult:
    """Plain version: the mode's risk (``risk.obstacle_risk``) and
    :func:`chain_tail` on the candidates gathered in residual order, with
    what the chain reads where the mode reads nothing (:func:`filled`).
    Arguments and result as :func:`outer_tail`."""
    cand = candidates(pj, order, params, frenet)
    beta, sigma, x_roll, y_roll = filled(cfg, order.shape, order.device, beta, sigma,
                                         x_roll, y_roll)
    risk_obs = risk.obstacle_risk(cfg, beta, sigma, x_roll, y_roll, x_obs, y_obs)
    cand.update(roll=y_roll, beta=beta, sigma=sigma)
    return chain_tail(cfg, frenet, risk_obs, cand, z, mean, cov, v_des, res, res_2, it)


def quantile_at(alpha: float, R: int):
    """torch.quantile's linear interpolation of R sorted samples at
    alpha on the card: (the lower position, the upper one, the weight),
    from the float32 rank alpha (R - 1)."""
    rank = np.float32(alpha) * np.float32(R - 1)
    lo = int(rank)
    return lo, int(np.ceil(rank)), float(rank - np.float32(lo))


def constants(cfg: ProblemConfig):
    """The kernel's float32 constants, rounded as the plain chain rounds
    them on the card (a tensor over a Python float is a product with the
    float32 reciprocal)."""
    f32 = lambda v: float(np.float32(v))
    inv = lambda v: float(np.float32(1.0) / np.float32(v))
    c, rk, lane, veh, fr = cfg.cem, cfg.risk, cfg.lane, cfg.vehicle, cfg.frenet
    w_lane, w_obs = rk.weights()
    return [inv(cfg.obstacles.a_obs ** 2), inv(cfg.obstacles.b_obs ** 2), f32(lane.y_lb),
            f32(lane.y_ub), f32(rk.ker_wt), f32(w_obs), f32(w_lane),
            f32(rk.weight_lane_des), f32(lane.y_des_1), f32(lane.y_des_2),
            f32(lane.gamma_lane_des), f32(veh.steer_max), f32(fr.weight_des_lane),
            f32(fr.weight_centr), f32(veh.a_centr), inv(c.lamda),
            f32(1.0 - c.alpha_mean), f32(c.alpha_mean), f32(1.0 - c.alpha_cov),
            f32(c.alpha_cov), f32(c.cov_jitter), f32(veh.v_min), f32(veh.v_max),
            *quantile_at(rk.alpha_quant, rk.num_reduced),
            *quantile_at(rk.alpha_quant_lane, rk.num_reduced), inv(rk.num_reduced)]


def _check(cfg, pj, order, params, beta, sigma, x_roll, y_roll, x_obs, y_obs, z, mean,
           cov, v_des, res, res_2, it):
    """(N, nb, R, T); raises on arguments neither version takes: beta and
    sigma are given in the MMD modes alone and None in the others, the
    rollouts in every mode but ``det``."""
    if order.dim() != 2:
        raise ValueError(f"outer_tail: order {tuple(order.shape)} must be (N, nb)")
    N, nb = order.shape
    c = cfg.cem
    R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
    num, n_el = cfg.horizon.num, c.ellite_num
    mode = cfg.risk.mode
    if mode not in RISK_MODES:
        raise ValueError(f"outer_tail: a mode of {RISK_MODES}, got {mode!r}")
    mmd = mode in ("mmd_opt", "mmd_random")
    for name, t, reads in (("beta", beta, mmd), ("sigma", sigma, mmd),
                           ("x_roll", x_roll, mode != "det"),
                           ("y_roll", y_roll, mode != "det")):
        if (t is not None) != reads:
            raise ValueError(f"outer_tail: {name} must be "
                             f"{'given' if reads else 'None'} in {mode}, which "
                             f"{'reads' if reads else 'does not read'} it")
    want = {"params": (params, (N, nb, 8)), "beta": (beta, (N, nb, R)),
            "sigma": (sigma, (N, nb)), "x_roll": (x_roll, (N, nb, R, T)),
            "y_roll": (y_roll, (N, nb, R, T)), "z": (z, (N, nb - n_el, 8)),
            "mean": (mean, (N, 8)), "cov": (cov, (N, 8, 8)),
            "res": (res, (N, c.maxiter_cem)), "res_2": (res_2, (N, c.maxiter_cem)),
            "y": (pj.y, (N * nb, num)), "res_norm": (pj.res_norm, (N * nb,))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"outer_tail: {name} {tuple(t.shape)} must be {shape}")
    if (x_obs.dim() != 3 or x_obs.shape[0] != N or x_obs.shape[-1] < T
            or y_obs.shape != x_obs.shape):
        raise ValueError(f"outer_tail: x_obs, y_obs {tuple(x_obs.shape)} must be "
                         f"(N, num_obs, >= {T})")
    if not (0 < n_el <= min(c.ellite_num_cost, nb)) or not 0 <= it < c.maxiter_cem:
        raise ValueError(f"outer_tail: needs 0 < ellite_num <= ellite_num_cost, "
                         f"num_batch and 0 <= it < maxiter_cem, got {n_el}, "
                         f"{c.ellite_num_cost}, {nb}, {it}")
    if v_des.numel() != 1:
        raise ValueError("outer_tail: v_des must be one value")
    return N, nb, R, T


def outer_tail(cfg: ProblemConfig, frenet: bool, pj: OuterProjection,
               order: torch.Tensor, params: torch.Tensor, beta: Optional[torch.Tensor],
               sigma: Optional[torch.Tensor], x_roll: Optional[torch.Tensor],
               y_roll: Optional[torch.Tensor],
               x_obs: torch.Tensor, y_obs: torch.Tensor, z: torch.Tensor,
               mean: torch.Tensor, cov: torch.Tensor, v_des: torch.Tensor,
               res: torch.Tensor, res_2: torch.Tensor, it: int, *, cluster: int = 0,
               lib=None, clock: Optional[torch.Tensor] = None,
               kept_cta: Optional[torch.Tensor] = None) -> TailResult:
    """The step of outer iteration ``it`` of a chunk of N scenarios, from
    the projection's rows and the candidates' rollouts to the next CEM
    moments and parameters, in the risk mode of ``cfg``.

    pj the iteration's :class:`OuterProjection` (rows N nb, scenario after
    scenario); order (N, nb) int64 its stable sort by residual; params (N,
    nb, 8) the iteration's parameters by projection row; beta (N, nb, R),
    sigma (N, nb), x_roll, y_roll (N, nb, R, T) the reduced sets (in
    ``mmd_opt``) or the R rollouts of the candidates in residual order (the
    Frenet points on the road); beta and sigma None in ``cvar``, ``saa``
    and ``det``, which read neither, and the rollouts None in ``det``,
    which reads none; x_obs, y_obs (N, num_obs, >= T) the obstacles; z (N,
    nb - ellite_num, 8) the resample's normals; mean (N, 8), cov (N, 8,
    8); v_des one value.  ``frenet`` takes the on-road cost
    (``pj.steering`` and ``pj.kappa_interp``) for the straight-road one
    (``pj.steer``).  Writes res[:, it] and res_2[:, it]; returns
    :class:`TailResult`.

    CPU tensors take :func:`outer_tail_plain`; CUDA tensors launch kernel
    (e) in the mode's form (float32 and an int64 order, one device; nb <=
    256, ellite_num_cost <= 32, R <= 16, T <= 64) or raise.  ``cluster``
    forces the cluster size (1, 2, 4, 8; 0 lets the kernel pick); ``lib``
    another build of the kernels' library (``utils/kernel_ab.py``);
    ``clock`` an int64 tensor of N cluster x 8 for the clock64 stamps of
    each CTA's phases; ``kept_cta`` an int64 tensor of N cluster x
    ellite_num_cost for the kept candidates each CTA ranked (every CTA of
    a scenario ranks the risks itself).
    """
    N, nb, R, T = _check(cfg, pj, order, params, beta, sigma, x_roll, y_roll, x_obs,
                         y_obs, z, mean, cov, v_des, res, res_2, it)
    if cluster not in (0, 1, 2, 4, 8):
        raise ValueError(f"outer_tail: a cluster of 0, 1, 2, 4 or 8 CTAs, got {cluster}")
    rows = [getattr(pj, name) for name in _ROWS] + [
        pj.steering if frenet else pj.steer] + ([pj.kappa_interp] if frenet else [])
    mode = cfg.risk.mode
    floats = [params, beta, sigma, x_roll, y_roll, x_obs, y_obs, z, mean, cov, v_des]
    given = [t for t in floats if t is not None]
    if all(t.device.type == "cpu" for t in [order, res, res_2] + rows + given):
        return outer_tail_plain(cfg, frenet, pj, order, params, beta, sigma, x_roll,
                                y_roll, x_obs, y_obs, z, mean, cov, v_des, res, res_2, it)
    c = cfg.cem
    n_cost = min(c.ellite_num_cost, nb)   # the kept: argsort(...)[:, :n_cost]
    if not (nb <= 256 and n_cost <= 32 and R <= 16 and T <= 64):
        raise ValueError(f"outer_tail: the kernel takes num_batch <= 256, "
                         f"ellite_num_cost <= 32, R <= 16 and T <= 64, got {nb}, "
                         f"{n_cost}, {R}, {T}")
    floats = [None if t is None else t.contiguous() for t in floats]
    _build.require_cuda_f32("outer_tail", *rows, *(t for t in floats if t is not None), res,
                            res_2)
    if order.dtype != torch.int64 or order.device != res.device:
        raise TypeError("outer_tail: order must be int64 on the tensors' device")
    order = order.contiguous()
    dev = res.device
    out_f = [torch.empty(s, dtype=torch.float32, device=dev)
             for s in ((N, 8), (N, 8, 8), (N, nb, 8))]
    best = torch.empty(N, dtype=torch.int64, device=dev)
    risk_obs, risk_lane = (torch.empty(N, dtype=torch.float32, device=dev)
                           for _ in range(2))
    kept = torch.empty(N, n_cost, dtype=torch.int64, device=dev)
    elites = torch.empty(N, c.ellite_num, dtype=torch.int64, device=dev)
    kappa = rows.pop() if frenet else None
    lib = lib or _build.library()
    err = lib.mmd_outer_tail(
        order.data_ptr(), *(t.data_ptr() for t in rows),
        None if kappa is None else kappa.data_ptr(),
        *(None if t is None else t.data_ptr() for t in floats),
        *(t.data_ptr() for t in out_f), res.data_ptr(), res_2.data_ptr(),
        risk_obs.data_ptr(), risk_lane.data_ptr(), best.data_ptr(), kept.data_ptr(),
        elites.data_ptr(), None if clock is None else clock.data_ptr(),
        None if kept_cta is None else kept_cta.data_ptr(),
        N, nb, n_cost, c.ellite_num, R, T, cfg.horizon.num, x_obs.shape[1],
        x_obs.shape[2], c.maxiter_cem, it, KINDS.index(cfg.risk.kernel),
        RISK_MODES.index(mode), int(frenet),
        int(frenet and mode != "det" and cfg.risk.weight_lane_des != 0.0),
        cluster, *constants(cfg), _build.stream())
    _build.check(err, "outer_tail")
    outer_tail.launches += 1
    return TailResult(*out_f, best, risk_obs, risk_lane, kept, elites)


outer_tail.launches = 0


def last_cluster_size() -> int:
    """CTAs a scenario (1, 2, 4 or 8) in the last launch of kernel (e)."""
    return _build.library().mmd_outer_tail_last_cluster()
