"""Scenario generation: static obstacle grids and dynamic cut-in traffic.

Counterpart of ``mpc_mmd_tpu/scenarios.py``, with its signatures and field
names.  ``static_grid`` draws with numpy's ``RandomState(seed0 + k)`` as the
JAX package does, so it is bit-equal to it.

``dynamic_cutin`` draws the JAX package's ``jax.random`` chain with the
port's copy of it (``prng.py``), on the host: obstacle positions and
speeds by ``choice`` without replacement from ``PRNGKey(seed0 + k)`` on
its 30- and 15-point grids, desired speeds from ``PRNGKey(43 (seed0 + k) +
11 t + 5)``, for any configs and up to the 15 obstacles the speed grid
allows (more raise, as ``jax.random.choice`` does).  The obstacles'
tracking QP then runs here: a float64 precompute on the host and a
float32 solve on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .basis import uniform_basis
from .config import ProblemConfig
from .device import resolve_device


class ScenarioBatch(NamedTuple):
    """A batch of S obstacle scenarios (trajectories over the full horizon)."""

    x_obs: torch.Tensor      # (S, num_obs) initial positions
    y_obs: torch.Tensor
    vx_obs: torch.Tensor
    vy_obs: torch.Tensor
    psi_obs: torch.Tensor
    x_traj: torch.Tensor     # (S, num_obs, num)
    y_traj: torch.Tensor


_STATIC_X_GRID = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], dtype=np.float64)
_LANE_YS = np.array([-1.75, 1.75])


def static_grid(cfg: ProblemConfig, n_configs: int, seed0: int = 0,
                device="cuda") -> ScenarioBatch:
    """Random static obstacles on the 2-lane grid; config k uses numpy seed
    seed0 + k (the reference's compute_obs_data).  Tensors on ``device``
    (the card by default; ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    n_obs = cfg.obstacles.num_obs
    num = cfg.horizon.num
    xs = np.zeros((n_configs, n_obs))
    ys = np.zeros((n_configs, n_obs))
    for k in range(n_configs):
        rng = np.random.RandomState(seed0 + k)
        xs[k] = rng.choice(_STATIC_X_GRID, (n_obs,), replace=False)
        ys[k] = rng.choice(_LANE_YS, (n_obs,))
    zeros = np.zeros_like(xs)
    x_traj = np.repeat(xs[:, :, None], num, axis=2)
    y_traj = np.repeat(ys[:, :, None], num, axis=2)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return ScenarioBatch(f32(xs), f32(ys), f32(zeros), f32(zeros), f32(zeros),
                         f32(x_traj), f32(y_traj))


def _obs_guess_workspace(cfg: ProblemConfig):
    """The obstacles' velocity/offset tracking QP over one segment spanning
    the horizon, in float64 (mpc_mmd_tpu/scenarios.py:80-114): the basis P,
    the two inverse KKT matrices and the linear-cost directions."""
    h = cfg.horizon
    basis = uniform_basis(h.order, h.t_fin, h.num)
    P, Pdot, Pddot = basis.P, basis.Pdot, basis.Pddot
    k_p_v, k_p = 2.0, 2.0
    w_smooth = 100.0
    rho_v, rho_off = 1.0, 1.0

    A_eq_x = np.vstack((P[0], Pdot[0], Pddot[0]))
    A_eq_y = np.vstack((P[0], Pdot[0], Pddot[0], Pdot[-1]))
    A_vd = Pddot - k_p_v * Pdot
    A_pd = Pddot - k_p * P
    cost_x = w_smooth * Pddot.T @ Pddot + rho_v * A_vd.T @ A_vd
    cost_y = w_smooth * Pddot.T @ Pddot + rho_off * A_pd.T @ A_pd

    def kkt(cost, A):
        m = A.shape[0]
        return np.block([[cost, A.T], [A, np.zeros((m, m))]])

    ones = np.ones(h.num)
    return dict(P=P, kkt_x_inv=np.linalg.inv(kkt(cost_x, A_eq_x)),
                kkt_y_inv=np.linalg.inv(kkt(cost_y, A_eq_y)),
                g_vx=rho_v * k_p_v * (A_vd.T @ ones),
                g_py=rho_off * k_p * (A_pd.T @ ones))


# jnp.linspace(15, 45, 30) and jnp.linspace(0.5, 5, 15) as the JAX package
# draws from them (scenarios.py:126-127): XLA's float32 rounding, which
# numpy's linspace does not give
_CUTIN_X_GRID = (
    15, 16.034483, 17.0689659, 18.103447, 19.1379299, 20.1724129, 21.2068958,
    22.2413788, 23.2758598, 24.3103447, 25.3448277, 26.3793087, 27.4137936,
    28.4482746, 29.4827576, 30.5172405, 31.5517235, 32.5862045, 33.6206894,
    34.6551704, 35.6896553, 36.7241364, 37.7586212, 38.7931023, 39.8275833,
    40.8620682, 41.8965492, 42.9310341, 43.9655151, 45)
_CUTIN_V_GRID = (
    0.5, 0.821428537, 1.14285719, 1.46428573, 1.78571439, 2.10714293,
    2.42857146, 2.75, 3.07142854, 3.39285707, 3.71428585, 4.03571415,
    4.35714293, 4.6785717, 5)


def cutin_draws(n_obs: int, n_configs: int, seed0: int = 0):
    """x0, vx0, v_des (n_configs, n_obs) float32 on the CPU: the JAX
    package's cut-in draws (mpc_mmd_tpu/scenarios.py:128-140)."""
    k = torch.arange(seed0, seed0 + n_configs, dtype=torch.int64)
    keys = torch.stack((torch.zeros_like(k), k & prng.M32), dim=-1)
    grid = lambda g: torch.tensor(g, dtype=torch.float32)
    x0 = prng.choice(keys, grid(_CUTIN_X_GRID), (n_obs,), replace=False)
    vx0 = prng.choice(keys, grid(_CUTIN_V_GRID), (n_obs,), replace=False)
    v_seed = 43 * k[:, None] + 11 * torch.arange(n_obs) + 5
    v_keys = torch.stack((torch.zeros_like(v_seed), v_seed & prng.M32), dim=-1)
    v_des = prng.normal(v_keys, ()) * 0.1 + 6.0
    return x0, vx0, v_des


def dynamic_cutin(cfg: ProblemConfig, n_configs: int, y_target: float = -1.75,
                  seed0: int = 0, device="cuda") -> ScenarioBatch:
    """Cut-in traffic: obstacles at y = +1.75 with v ~ N(6, 0.1) tracking
    y_target, for configs seed0 .. seed0 + n_configs - 1 (at most 15
    obstacles, see the module docstring).  The obstacles' QP is solved on
    ``device`` (the card by default; ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    n_obs = cfg.obstacles.num_obs
    nvar = cfg.horizon.nvar
    x0, vx0, v_des = (torch.as_tensor(a, device=device)
                      for a in cutin_draws(n_obs, n_configs, seed0))
    ws = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
          for k, v in _obs_guess_workspace(cfg).items()}
    zero = torch.zeros_like(x0)
    # lincost = +k_p_v v_des (A_vd^T 1); the KKT right-hand side carries
    # -lincost, then the equality values
    rhs_x = torch.cat((-v_des[..., None] * ws["g_vx"],
                       torch.stack((x0, vx0, zero), dim=-1)), dim=-1)
    b_eq_y = torch.tensor([1.75, 0.0, 0.0, 0.0], device=device)
    rhs_y = torch.cat((-y_target * ws["g_py"], b_eq_y))
    cx = (rhs_x @ ws["kkt_x_inv"].T)[..., :nvar]           # (S, n_obs, nvar)
    cy = (ws["kkt_y_inv"] @ rhs_y)[:nvar]                   # shared by all
    x_traj = cx @ ws["P"].T
    y_traj = (ws["P"] @ cy).expand(x_traj.shape).contiguous()
    y0 = torch.full_like(x0, 1.75)
    return ScenarioBatch(x0, y0, vx0, zero, zero, x_traj, y_traj)


def ego_initial_state(workload: str = "static"):
    """(init_state (6,), cem mean (8,), cem cov (8, 8), v_des) as numpy.

    The ego starts at y = +1.75 in the static workload and at y = -1.75 in
    the dynamic one (mpc_mmd_tpu/scenarios.py:158-170).
    """
    y0 = 1.75 if workload == "static" else -1.75
    v_des = 15.0
    init_state = np.asarray([0.0, y0, 5.0, 0.0, 0.0, 0.0], np.float32)
    mean = np.asarray([v_des] * 4 + [0.0] * 4, np.float32)
    cov = np.diag([20.0] * 4 + [100.0] * 4).astype(np.float32)
    return init_state, mean, cov, v_des
