"""Bicycle-kinematics rollouts under gaussian or Beta control noise.

Counterpart of ``mpc_mmd_tpu/dynamics.py``.  :func:`rollout` is the plain
twin of the K4 rollout kernel (``ops/rollout.py``): a Python loop over time,
which on a GPU would launch about ten kernels per step, so the solver calls
the kernel's wrapper, and the wrapper takes this loop only for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import NoiseConfig


def step(acc: torch.Tensor, steer: torch.Tensor, state: torch.Tensor,
         dt: float, wheel_base: float) -> torch.Tensor:
    """One Euler step; state (B, 5) rows [x, y, vx, vy, psi], acc/steer (B,)."""
    x, y, vx, vy, psi = state.unbind(1)
    v = torch.sqrt(vx * vx + vy * vy) + acc * dt
    psi_next = psi + v * torch.tan(steer) / wheel_base * dt
    vx_next = v * torch.cos(psi_next)
    vy_next = v * torch.sin(psi_next)
    x_next = x + vx_next * dt
    y_next = y + vy_next * dt
    return torch.stack((x_next, y_next, vx_next, vy_next, psi_next), dim=1)


def rollout(acc: torch.Tensor, steer: torch.Tensor, state0: torch.Tensor,
            dt: float, wheel_base: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Roll T steps for B lanes; returns x, y position stacks (B, T).

    acc, steer: (B, T); state0: (B, 5) or (5,).  Column t holds the state
    before controls[t] is applied.
    """
    B, T = acc.shape
    state = state0.expand(B, 5) if state0.dim() == 1 else state0
    xs, ys = [], []
    for t in range(T):
        xs.append(state[:, 0])
        ys.append(state[:, 1])
        state = step(acc[:, t], steer[:, t], state, dt, wheel_base)
    return torch.stack(xs, dim=1), torch.stack(ys, dim=1)


def beta_parameters(acc: torch.Tensor, steer: torch.Tensor,
                    noise: NoiseConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beta noise parameters (2, ..., T) of the (acc, steer) channels.

    Beta(a |u|, b |u|) per step, with |u| floored at 1e-8 as in the JAX
    package (dynamics.py:99-109): every candidate's steer is exactly 0 at
    t = 0, and Beta(0, 0) is undefined.
    """
    u = torch.abs(torch.stack((acc, steer))) + 1e-8
    return noise.beta_a * u, noise.beta_b * u


def mc_beta_parameters(acc: torch.Tensor, steer: torch.Tensor,
                       noise: NoiseConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Monte-Carlo validator's Beta parameters (2, ..., T), which are
    not the solve's (mpc_mmd_tpu/validate.py:50-54): Beta(a |acc|, b |acc|)
    with no floor, and Beta(a |steer| + 1e-5, b |steer| + 1e-5).  Where acc
    is exactly 0 that is Beta(0, 0): the draw, and with it the rollout from
    that step on, is NaN, as ``jax.random.beta`` makes it.
    """
    a_acc, a_steer = torch.abs(acc), torch.abs(steer)
    return (torch.stack((noise.beta_a * a_acc, noise.beta_a * a_steer + 1e-5)),
            torch.stack((noise.beta_b * a_acc, noise.beta_b * a_steer + 1e-5)))


def perturb_controls(acc: torch.Tensor, steer: torch.Tensor,
                     d_acc: torch.Tensor, d_steer: torch.Tensor,
                     eps_const: torch.Tensor, noise: NoiseConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noisy variants of control sequences from injected draws.

    acc, steer: (..., T).  Returns (..., R, T) each.  Gaussian noise: d_acc
    and d_steer are standard normals (R, T) shared by every leading index
    (or (N, 1, R, T), one set per scenario of a chunk of candidates (N, C,
    T)), and the perturbation is ``level * |u| * d``.  Beta noise: they are
    the (..., R, T) Beta draws of :func:`beta_parameters`' parameters, and
    the perturbation is ``level * (2 d - 1)``, scaled by ``k_steer`` on the
    steer channel.  Both add the reference's const noise, whose single
    (R, T) draw (a scenario's) perturbs both channels.
    """
    acc = acc[..., None, :]
    steer = steer[..., None, :]
    if noise.kind == "gaussian":
        acc_pert = noise.level * torch.abs(acc) * d_acc
        steer_pert = noise.level * torch.abs(steer) * d_steer
    else:
        acc_pert = noise.level * (2.0 * d_acc - 1.0)
        steer_pert = noise.k_steer * noise.level * (2.0 * d_steer - 1.0)
    acc_noisy = acc + acc_pert + noise.acc_const * eps_const
    steer_noisy = steer + steer_pert + noise.steer_const * eps_const
    return acc_noisy, steer_noisy


def controls_from_trajectory(xdot: torch.Tensor, ydot: torch.Tensor,
                             xddot: torch.Tensor, yddot: torch.Tensor,
                             dt: float, wheel_base: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc, steer) along a flat trajectory batch, inputs (..., T).

    acc is the forward difference of speed with the last value repeated
    (so its last column is 0); steer = atan(kappa * L).
    """
    v = torch.sqrt(xdot ** 2 + ydot ** 2)
    v_ext = torch.cat((v, v[..., -1:]), dim=-1)
    acc = torch.diff(v_ext, dim=-1) / dt
    curvature = (yddot * xdot - ydot * xddot) / ((xdot ** 2 + ydot ** 2) ** 1.5)
    steer = torch.atan(curvature * wheel_base)
    return acc, steer


def constant_velocity_obstacles(x0: torch.Tensor, y0: torch.Tensor,
                                vx: torch.Tensor, vy: torch.Tensor,
                                psi: torch.Tensor, tot_time: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Obstacle trajectories (num_obs, num) from (num_obs,) states."""
    x_traj = x0[:, None] + vx[:, None] * tot_time[None, :]
    y_traj = y0[:, None] + vy[:, None] * tot_time[None, :]
    psi_traj = psi[:, None].expand(x_traj.shape)
    return x_traj, y_traj, psi_traj
