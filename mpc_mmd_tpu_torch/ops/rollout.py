"""K4: fused bicycle-kinematics rollout (CUDA source ``csrc/rollout.cu``).

Replaces ``mpc_mmd_tpu/ops/rollout_pallas.py::fused_rollout``.  In the JAX
package that kernel is opt-in; here it is the rollout of the main path:
6400 lanes (64 candidates x 100 mother rollouts) x 50 steps per outer
iteration.  What bounds it on the card and what the design does about it:
see the note at the top of the CUDA source.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..dynamics import rollout as rollout_plain


def fused_rollout(acc: torch.Tensor, steer: torch.Tensor, state0: torch.Tensor,
                  dt: float, wheel_base: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, y position stacks (L, T) of lanes driven by acc, steer (L, T).

    state0 is (5,) shared by every lane or (L, 5).  Column t holds the state
    before controls[t].  A CPU tensor takes the plain loop
    (``dynamics.rollout``); a CUDA tensor launches the kernel (float32,
    contiguous).
    """
    if acc.dim() != 2 or steer.shape != acc.shape:
        raise ValueError(f"fused_rollout: acc {tuple(acc.shape)} and steer "
                         f"{tuple(steer.shape)} must be the same (L, T)")
    L, T = acc.shape
    if state0.shape not in ((5,), (L, 5)):
        raise ValueError(f"fused_rollout: state0 {tuple(state0.shape)} is "
                         f"neither (5,) nor ({L}, 5)")
    if acc.device.type == "cpu":
        return rollout_plain(acc, steer, state0, dt, wheel_base)
    _build.require_cuda_f32("fused_rollout", acc, steer, state0)
    x = torch.empty_like(acc)
    y = torch.empty_like(acc)
    err = _build.library().mmd_fused_rollout(
        acc.data_ptr(), steer.data_ptr(), state0.data_ptr(),
        0 if state0.dim() == 1 else 5, x.data_ptr(), y.data_ptr(), L, T,
        float(dt), float(wheel_base), _build.stream())
    _build.check(err, "fused_rollout")
    fused_rollout.launches += 1
    return x, y


fused_rollout.launches = 0
