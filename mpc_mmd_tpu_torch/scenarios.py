"""Scenario data of the port: dynamic cut-in traffic and the ego's start.

``data/dynamic_cutin.npz`` holds ``x_traj`` and ``y_traj`` (4, 6, 100),
float32: the first 4 scenarios of the JAX package's
``mpc_mmd_tpu.scenarios.dynamic_cutin(dynamic_workload(), 4)`` (six
obstacles spawned in the left lane cutting into the ego's lane over the
15 s horizon).  They are drawn with ``jax.random``, so the port carries
them as data; ``tests/test_torch_scenarios.py`` holds the file to its
source.  To write it again::

    python -c "import numpy as np; from mpc_mmd_tpu import config, scenarios; \\
      b = scenarios.dynamic_cutin(config.dynamic_workload(), 4); \\
      np.savez('mpc_mmd_tpu_torch/data/dynamic_cutin.npz', \\
               x_traj=np.asarray(b.x_traj), y_traj=np.asarray(b.y_traj))"
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch

DYNAMIC_CUTIN = Path(__file__).resolve().parent / "data" / "dynamic_cutin.npz"


def dynamic_cutin(device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored cut-in scenarios: x_traj, y_traj (4, num_obs, num)."""
    with np.load(DYNAMIC_CUTIN) as f:
        return tuple(torch.as_tensor(f[n], device=device)
                     for n in ("x_traj", "y_traj"))


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
