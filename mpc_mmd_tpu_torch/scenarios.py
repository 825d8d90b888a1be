"""Scenario generation: static obstacle grids and dynamic cut-in traffic.

Counterpart of ``mpc_mmd_tpu/scenarios.py``, with its signatures and field
names.  ``static_grid`` draws with numpy's ``RandomState(seed0 + k)`` as the
JAX package does, so it is bit-equal to it.

``dynamic_cutin`` draws with ``jax.random`` in the JAX package (obstacle
positions and speeds by ``jax.random.choice`` from ``PRNGKey(k)``, desired
speeds from ``PRNGKey(43 k + 11 t + 5)``), which torch cannot reproduce.
The port carries those draws as data, ``data/dynamic_cutin_params.npz``:
``x0``, ``vx0`` and ``v_des``, float32 (1200, 15), for config indices
0-1199 and 15 obstacle slots, the most the 15-point speed grid allows.
``jax.random.choice(..., replace=False)`` takes a prefix of one
permutation, so slot t of config k is the same draw for every
``num_obs``.  The obstacles' tracking QP then runs here: a float64
precompute on the host and a float32 solve on the device.  To write the
file again, with the JAX key chain that ``tests/test_torch_scenarios.py``
holds it to (JAX needed)::

    python -c "import sys, numpy as np; sys.path.insert(0, 'tests'); \\
      from test_torch_scenarios import jax_cutin_draws; \\
      x0, vx0, v_des = jax_cutin_draws(1200, 15); \\
      np.savez_compressed('mpc_mmd_tpu_torch/data/dynamic_cutin_params.npz', \\
                          x0=x0, vx0=vx0, v_des=v_des)"
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .basis import uniform_basis
from .config import ProblemConfig
from .device import resolve_device

CUTIN_PARAMS = Path(__file__).resolve().parent / "data" / "dynamic_cutin_params.npz"


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


def _cutin_params(n_obs: int, n_configs: int, seed0: int):
    """x0, vx0, v_des (n_configs, n_obs) from the data file."""
    with np.load(CUTIN_PARAMS) as f:
        x0, vx0, v_des = f["x0"], f["vx0"], f["v_des"]
    n_rows, n_slots = x0.shape
    if n_obs > n_slots or seed0 < 0 or seed0 + n_configs > n_rows:
        raise ValueError(
            f"dynamic_cutin: the port holds the cut-in draws of configs "
            f"0-{n_rows - 1} with {n_slots} obstacles in {CUTIN_PARAMS}; "
            f"asked for configs {seed0}-{seed0 + n_configs - 1} with {n_obs}. "
            "Rewrite the file with the script in the docstring of "
            "mpc_mmd_tpu_torch/scenarios.py, widened to what is asked.")
    sl = slice(seed0, seed0 + n_configs)
    return x0[sl, :n_obs], vx0[sl, :n_obs], v_des[sl, :n_obs]


def dynamic_cutin(cfg: ProblemConfig, n_configs: int, y_target: float = -1.75,
                  seed0: int = 0, device="cuda") -> ScenarioBatch:
    """Cut-in traffic: obstacles at y = +1.75 with v ~ N(6, 0.1) tracking
    y_target, for configs seed0 .. seed0 + n_configs - 1 (at most 1200 and
    15 obstacles, see the module docstring).  The obstacles' QP is solved
    on ``device`` (the card by default; ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    n_obs = cfg.obstacles.num_obs
    nvar = cfg.horizon.nvar
    x0, vx0, v_des = (torch.as_tensor(a, device=device)
                      for a in _cutin_params(n_obs, n_configs, seed0))
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
