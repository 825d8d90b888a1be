"""Monte-Carlo validation of solved trajectories.

Counterpart of ``mpc_mmd_tpu/validate.py``.  For each stored solve the
validator re-extracts the controls from the Bernstein coefficients, rolls
``n_mc`` (default 1000) noisy rollouts and reduces them to collision and
lane-violation counts: the most rollouts violating at once, over
obstacles and time steps (the reference's validation.py:153-169).

The JAX package runs the whole set as one vmapped program.  Here solves
go in chunks of ``CHUNK``: per chunk the controls, the noisy controls
from the noise source's per-row draws, one K4 rollout call over every
lane of the chunk, and the ellipse test one obstacle at a time, so the
largest temporaries are (chunk, n_mc, T).  Results stay on the device
until the caller fetches them: no host synchronisation per solve.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .config import ProblemConfig
from .dynamics import (controls_from_trajectory, mc_beta_parameters,
                       perturb_controls)
from .noise import TorchNoise
from .ops import fused_rollout
from .qp import Workspace

# Solves per chunk: 256,000 rollout lanes per K4 call at n_mc = 1000, and
# (256, 1000, 50) float32 temporaries of 51 MB; 1200 solves in 5 chunks.
CHUNK = 256


class ValidationStats(NamedTuple):
    coll_count: torch.Tensor     # (S,) int32: most rollouts colliding at once
    lane_count: torch.Tensor     # (S,) int32: lane lb + ub violation count
    coll_fraction: torch.Tensor  # (S,) float32: rollouts that ever collide


def mc_rollouts(cfg: ProblemConfig, ws: Workspace, cx: torch.Tensor,
                cy: torch.Tensor, init_state: torch.Tensor, noise, seed: int,
                rows: Sequence[int], n_mc: int):
    """x, y (S, n_mc, T) of the noisy rollouts of the solves cx, cy
    (S, nvar), drawn for solve rows ``rows``, from one shared init_state."""
    T, dt, L = cfg.horizon.num_prime, cfg.horizon.dt, cfg.vehicle.wheel_base
    S = cx.shape[0]
    acc, steer = controls_from_trajectory(cx @ ws.Pdot.T, cy @ ws.Pdot.T,
                                          cx @ ws.Pddot.T, cy @ ws.Pddot.T,
                                          dt, L)
    acc, steer = acc[:, :T], steer[:, :T]
    params = (None if cfg.noise.kind == "gaussian"
              else mc_beta_parameters(acc, steer, cfg.noise))
    d_acc, d_steer, eps = noise.mc_draws(seed, rows, n_mc, T, params)
    acc_n, steer_n = perturb_controls(acc, steer, d_acc, d_steer, eps, cfg.noise)
    state0 = torch.stack((init_state[0], init_state[1], init_state[2],
                          init_state[3], torch.atan2(init_state[3], init_state[2])))
    x, y = fused_rollout(acc_n.reshape(S * n_mc, T), steer_n.reshape(S * n_mc, T),
                         state0, dt, L)
    return x.view(S, n_mc, T), y.view(S, n_mc, T)


def _counts(cfg: ProblemConfig, x: torch.Tensor, y: torch.Tensor,
            x_obs_traj: torch.Tensor, y_obs_traj: torch.Tensor) -> ValidationStats:
    """Collision and lane counts of rollouts x, y (S, n, T) against the
    obstacles (S, num_obs, num); the ellipse test in the JAX expression
    order, (1 - dx^2/a^2 - dy^2/b^2) > 0."""
    S, n, T = x.shape
    a2, b2 = cfg.obstacles.a_obs ** 2, cfg.obstacles.b_obs ** 2
    n_obs = x_obs_traj.shape[1]
    simultaneous = torch.empty((S, n_obs, T), dtype=torch.int32, device=x.device)
    ever = torch.zeros((S, n), dtype=torch.bool, device=x.device)
    for o in range(n_obs):
        dx = x - x_obs_traj[:, o, None, :T]
        dy = y - y_obs_traj[:, o, None, :T]
        viol = (1.0 - dx * dx / a2 - dy * dy / b2) > 0.0
        simultaneous[:, o] = viol.sum(dim=1, dtype=torch.int32)
        ever |= viol.any(dim=-1)
    lb = (cfg.lane.y_lb - y) > 0.0
    ub = (y - cfg.lane.y_ub) > 0.0
    lane = (lb.sum(dim=1, dtype=torch.int32).amax(dim=-1)
            + ub.sum(dim=1, dtype=torch.int32).amax(dim=-1))
    # XLA takes jnp.mean as sum * float32(1/n): 234/300 rounds to 0.77999997,
    # 234 * (1/300) to 0.78000003
    frac = ever.sum(dim=1, dtype=torch.float32) * (1.0 / n)
    return ValidationStats(simultaneous.amax(dim=(1, 2)), lane, frac)


def make_validator_core(cfg: ProblemConfig, ws: Workspace, n_mc: int = 1000,
                        noise=None, chunk: int = CHUNK):
    """Validator of explicitly keyed solves, on ws's device.

    Returns ``validate(cx, cy, init_state, x_obs_traj, y_obs_traj, seed,
    rows)``: cx, cy (S, nvar), init_state (6,) shared by every solve,
    obstacle trajectories (S, num_obs, num), and ``rows`` (S,) the solve
    rows that key each solve's draws (see ``noise.py``), as the JAX core
    takes one key per solve.  Inputs may be numpy arrays.  ``noise``
    defaults to :class:`TorchNoise` on the device.
    """
    dev = ws.P.device
    if noise is None:
        noise = TorchNoise(torch.Generator(device=dev), dev)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def validate_rows(cx, cy, init_state, x_obs_traj, y_obs_traj, seed: int,
                      rows: Sequence[int]) -> ValidationStats:
        cx, cy, init_state, xo, yo = map(f32, (cx, cy, init_state, x_obs_traj,
                                               y_obs_traj))
        rows = list(rows)
        if len(rows) != cx.shape[0]:
            raise ValueError(f"{len(rows)} rows for {cx.shape[0]} solves")
        parts = []
        for lo in range(0, cx.shape[0], chunk):
            sl = slice(lo, lo + chunk)
            x, y = mc_rollouts(cfg, ws, cx[sl], cy[sl], init_state, noise,
                               seed, rows[sl], n_mc)
            parts.append(_counts(cfg, x, y, xo[sl], yo[sl]))
        return ValidationStats(*(torch.cat(f) for f in zip(*parts)))

    return validate_rows


def make_validator(cfg: ProblemConfig, ws: Workspace, n_mc: int = 1000,
                   noise=None, chunk: int = CHUNK):
    """Batch validator: ``validate(cx, cy, init_state, x_obs_traj,
    y_obs_traj, seed=0)`` with solve i drawing as row i; stats (S,) each,
    on the device."""
    core = make_validator_core(cfg, ws, n_mc, noise, chunk)

    def validate(cx, cy, init_state, x_obs_traj, y_obs_traj,
                 seed: int = 0) -> ValidationStats:
        return core(cx, cy, init_state, x_obs_traj, y_obs_traj, seed,
                    range(len(cx)))

    return validate
