# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/rollout.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""K4n's stage: the rollouts of every candidate's noisy controls
(``dynamics.perturb_controls``, then the bicycle rollout of
``dynamics.rollout`` on every lane).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import NoiseConfig
from .dynamics import perturb_controls, rollout


def paired_rollouts(a_n: torch.Tensor, s_n: torch.Tensor, state0: torch.Tensor,
                    dt: float, wheel_base: float, mother: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollouts of every candidate's noisy controls, every lane at once.

    a_n, s_n: the (..., C, R, T) noisy controls.  With ``mother``, row m
    pairs acc draw m // R with steer draw m % R, giving n = R^2 rollouts
    per candidate; else n = R.  state0 is (5,), shared by every rollout,
    or (n, 5): rollout m of every candidate starts from state m (the
    Frenet solve's noisy initial states).
    Returns x, y of shape (..., C, n, T).
    """
    R, T = a_n.shape[-2:]
    if mother:
        a_n = torch.repeat_interleave(a_n, R, dim=-2)
        s_n = s_n.repeat(*(1,) * (s_n.dim() - 2), R, 1)
    lead, n = a_n.shape[:-2], a_n.shape[-2]
    if state0.dim() == 2:
        state0 = state0.expand(*lead, n, 5).reshape(-1, 5)
    x, y = rollout(a_n.reshape(-1, T), s_n.reshape(-1, T), state0, dt, wheel_base)
    return x.reshape(*lead, n, T), y.reshape(*lead, n, T)


def noisy_rollout(acc: torch.Tensor, steer: torch.Tensor, d_acc: torch.Tensor,
                  d_steer: torch.Tensor, eps_const: torch.Tensor, state0: torch.Tensor,
                  noise: NoiseConfig, dt: float, wheel_base: float, mother: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollouts (N, C, n, T) of the noisy variants of N x C candidates'
    controls acc, steer (N, C, T) from the iteration's draws d_acc, d_steer,
    eps_const (N, 1, R, T) and state0 (5,) or (n, 5); ``mother``: n = R^2
    rollouts a candidate, else n = R."""
    a_n, s_n = perturb_controls(acc, steer, d_acc, d_steer, eps_const, noise)
    return paired_rollouts(a_n, s_n, state0, dt, wheel_base, mother)
