"""The port's stored cut-in scenarios equal what the JAX package draws.

``mpc_mmd_tpu_torch/data/dynamic_cutin.npz`` is the first 4 scenarios of
``mpc_mmd_tpu.scenarios.dynamic_cutin(dynamic_workload(), 4)``; the port
cannot draw them (``jax.random``), so this test keeps the file from
drifting from its source.
"""

import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import scenarios as jscen
from mpc_mmd_tpu_torch import scenarios as tscen

torch.set_num_threads(1)


def test_stored_cutin_scenarios_equal_their_source():
    ref = jscen.dynamic_cutin(jc.dynamic_workload(), 4)
    xs, ys = tscen.dynamic_cutin()
    assert xs.shape == (4, 6, 100) and xs.dtype == torch.float32
    np.testing.assert_array_equal(xs.numpy(), np.asarray(ref.x_traj))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ref.y_traj))
    # the obstacles start in the left lane and cut into the ego's
    np.testing.assert_array_equal(ys[:, :, 0].numpy(), 1.75)
    assert float(ys[:, :, -1].max()) < -1.0


@pytest.mark.parametrize("workload", ["static", "dynamic"])
def test_ego_initial_state_matches_jax(workload):
    ref = jscen.ego_initial_state(workload)
    got = tscen.ego_initial_state(workload)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g, np.asarray(r))
    assert got[3] == ref[3]
