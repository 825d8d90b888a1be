"""PyTorch port vs JAX package: scenario generation.

``static_grid`` draws with numpy in both packages: bit-equal.
``dynamic_cutin`` draws with ``jax.random`` in the JAX package and with
the port's copy of it (``prng.py``) in the port: positions and speeds
equal, desired speeds within an ulp (the normal's ``log1p``); the port
solves the obstacles' tracking QP itself: trajectories within 1e-5 of
their scale (float32 matmuls summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import scenarios as jscen
from mpc_mmd_tpu_torch import scenarios as tscen
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)


def jax_cutin_draws(n_configs, n_slots):
    """The JAX package's cut-in draws (scenarios.py:128-140) for configs
    0..n_configs-1 and n_slots obstacles: x0, vx0, v_des."""
    x_grid, v_grid = jnp.linspace(15.0, 45.0, 30), jnp.linspace(0.5, 5.0, 15)

    def one(c):
        key = jax.random.PRNGKey(c)
        v_des = jax.vmap(lambda t: jax.random.normal(
            jax.random.PRNGKey(43 * c + 11 * t + 5), ()) * 0.1 + 6.0)(
                jnp.arange(n_slots))
        return (jax.random.choice(key, x_grid, (n_slots,), replace=False),
                jax.random.choice(key, v_grid, (n_slots,), replace=False), v_des)

    return tuple(map(np.asarray, jax.vmap(one)(jnp.arange(n_configs))))


def test_cutin_draws_equal_jax_draws():
    """The port's draws of configs 0-1199 with 15 obstacles (what the port
    once shipped as data) against the JAX key chain: x0 and vx0 equal,
    v_des within one ulp (2 of 18,000 differ, through the normal's float32
    log1p)."""
    got = tscen.cutin_draws(15, 1200)
    ref = jax_cutin_draws(1200, 15)
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == (1200, 15) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), r)
    np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=0,
                               atol=float(np.spacing(np.float32(6.0))))


@pytest.mark.parametrize("n_obs", [1, 4, 6, 8, 15])
def test_cutin_choice_is_prefix_stable(n_obs):
    """jax.random.choice without replacement draws a prefix of one
    permutation, so the 15 stored slots serve every num_obs."""
    x_grid, v_grid = jnp.linspace(15.0, 45.0, 30), jnp.linspace(0.5, 5.0, 15)
    full = jax_cutin_draws(40, 15)
    for k in (0, 7, 39):
        key = jax.random.PRNGKey(k)
        np.testing.assert_array_equal(
            np.asarray(jax.random.choice(key, x_grid, (n_obs,), replace=False)),
            full[0][k, :n_obs])
        np.testing.assert_array_equal(
            np.asarray(jax.random.choice(key, v_grid, (n_obs,), replace=False)),
            full[1][k, :n_obs])


@pytest.mark.parametrize("n_obs,n_configs,seed0", [(2, 30, 0), (6, 12, 1188)])
def test_dynamic_cutin_matches_jax(n_obs, n_configs, seed0):
    cfg = jc.dynamic_workload(num_obs=n_obs)
    ref = jscen.dynamic_cutin(cfg, n_configs, seed0=seed0)
    got = tscen.dynamic_cutin(to_torch_cfg(cfg), n_configs, seed0=seed0,
                              device="cpu")
    assert type(got).__name__ == "ScenarioBatch" and got._fields == ref._fields
    for name in ("x_obs", "y_obs", "vx_obs", "vy_obs", "psi_obs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("x_traj", "y_traj"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.shape == r.shape == (n_configs, n_obs, 100) and g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


def test_dynamic_cutin_past_configs_1199_matches_jax_and_refuses_16_obstacles():
    """Any configs: seed0 1190 and 20 configs as the JAX function draws
    them; 16 obstacles are more than the 15-point speed grid, and raise as
    ``jax.random.choice`` does."""
    cfg = jc.dynamic_workload(num_obs=6)
    ref = jscen.dynamic_cutin(cfg, 20, seed0=1190)
    got = tscen.dynamic_cutin(to_torch_cfg(cfg), 20, seed0=1190, device="cpu")
    for name in ("x_obs", "vx_obs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(got.x_traj.numpy(), np.asarray(ref.x_traj), rtol=0,
                               atol=1e-5 * float(np.abs(ref.x_traj).max()))
    with pytest.raises(ValueError, match="larger sample"):
        tscen.dynamic_cutin(to_torch_cfg(jc.dynamic_workload(num_obs=16)), 2,
                            device="cpu")


@pytest.mark.parametrize("n_obs,seed0", [(6, 0), (2, 5), (9, 0)])
def test_static_grid_is_bit_equal_to_jax(n_obs, seed0):
    cfg = jc.static_workload(num_obs=n_obs)
    ref = jscen.static_grid(cfg, 25, seed0=seed0)
    got = tscen.static_grid(to_torch_cfg(cfg), 25, seed0=seed0, device="cpu")
    for name in ref._fields:
        g = getattr(got, name)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_stored_cutin_scenarios_equal_their_source():
    """The first cut-in scenarios of the dynamic workload, as chip_smoke.py
    and the port's dynamic sweeps solve them."""
    cfg = jc.dynamic_workload()
    ref = jscen.dynamic_cutin(cfg, 4)
    got = tscen.dynamic_cutin(to_torch_cfg(cfg), 4, device="cpu")
    xs, ys = got.x_traj, got.y_traj
    assert xs.shape == (4, 6, 100) and xs.dtype == torch.float32
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref.x_traj), rtol=0,
                               atol=1e-5 * float(np.abs(ref.x_traj).max()))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref.y_traj), rtol=0,
                               atol=1e-5 * float(np.abs(ref.y_traj).max()))
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
