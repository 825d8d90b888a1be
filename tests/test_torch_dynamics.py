"""PyTorch port vs JAX package: rollout (K4's plain twin), noise, controls.

Gaussian and Beta control noise are compared on the JAX key chain's own
draws (``test_torch_noise.jax_draws`` and ``jax_beta``).

Tolerance: atol 1e-5 on rollout positions, the bound tests/test_ops.py
holds the Pallas rollout to against the scan, plus rtol 1e-6: torch's and
XLA's CPU sin/cos/tan differ in the last ulp, and after 50 steps positions
of 30 m (where one float32 ulp is 2e-6) differ by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import dynamics as jdyn
from mpc_mmd_tpu.ops import fused_rollout as j_fused_rollout
from mpc_mmd_tpu_torch import dynamics as tdyn
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops import fused_rollout
from mpc_mmd_tpu_torch.solver import noisy_controls
from test_torch_noise import jax_beta, jax_draws, to_torch_cfg

torch.set_num_threads(1)


def _controls(rng, L, T):
    acc = rng.normal(1, 0.5, (L, T)).astype(np.float32)
    steer = rng.normal(0, 0.1, (L, T)).astype(np.float32)
    return acc, steer


@pytest.mark.parametrize("L,T,per_lane", [(256, 50, False), (100, 20, False),
                                          (128, 25, True), (300, 50, True)])
def test_rollout_matches_scan_and_pallas_kernel(rng, L, T, per_lane):
    acc, steer = _controls(rng, L, T)
    state0 = (rng.normal(0, 1, (L, 5)) if per_lane
              else np.asarray([0.0, 1.75, 5.0, 0.0, 0.0])).astype(np.float32)
    dt, wb = 0.15, 2.5
    jx, jy = jdyn.rollout(jnp.asarray(acc), jnp.asarray(steer),
                          jnp.asarray(state0), dt, wb)
    kx, ky = j_fused_rollout(jnp.asarray(acc), jnp.asarray(steer),
                             jnp.asarray(state0), dt, wb, interpret=True)
    before = fused_rollout.launches
    tx, ty = fused_rollout(torch.from_numpy(acc), torch.from_numpy(steer),
                           torch.from_numpy(state0), dt, wb)
    assert fused_rollout.launches == before     # CPU tensors take the twin
    for t, r in ((tx, jx), (ty, jy), (tx, kx), (ty, ky)):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)
    # column 0 is the initial state: positions are recorded before a step
    s0 = np.broadcast_to(state0, (L, 5))
    np.testing.assert_array_equal(tx[:, 0].numpy(), s0[:, 0])


def test_step_matches_jax(rng):
    state = rng.normal(0, 3, (64, 5)).astype(np.float32)
    acc, steer = _controls(rng, 64, 1)
    ref = jdyn.step(jnp.asarray(acc[:, 0]), jnp.asarray(steer[:, 0]),
                    jnp.asarray(state), 0.15, 2.5)
    got = tdyn.step(torch.from_numpy(acc[:, 0]), torch.from_numpy(steer[:, 0]),
                    torch.from_numpy(state), 0.15, 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_fused_rollout_rejects_bad_shapes():
    acc = torch.zeros(4, 6)
    with pytest.raises(ValueError):
        fused_rollout(acc, torch.zeros(4, 5), torch.zeros(5), 0.1, 2.5)
    with pytest.raises(ValueError):
        fused_rollout(acc, acc, torch.zeros(3, 5), 0.1, 2.5)


@pytest.mark.parametrize("acc_const,steer_const", [(0.0, 0.0), (0.02, 0.01)])
def test_perturb_controls_on_injected_draws(rng, acc_const, steer_const):
    """The port on the JAX key chain's draws equals the JAX package's
    vmapped perturb_controls with the closed-over key (solver.py:115-116):
    every candidate sees the same (R, T) standard normals."""
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2, num_prime=20,
                             acc_const_noise=acc_const,
                             steer_const_noise=steer_const)
    C, R, T, it, idx_mpc = 5, 4, 20, 1, 42
    acc, steer = _controls(rng, C, T)
    key, _ = jax.random.split(jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))
    ja, js = jax.vmap(lambda a, s: jdyn.perturb_controls(
        key, a, s, R, cfg.noise))(jnp.asarray(acc), jnp.asarray(steer))
    d = jax_draws(cfg, idx_mpc)
    eps = [torch.from_numpy(d[n][it]) for n in ("eps_acc", "eps_steer", "eps_const")]
    ta, ts = tdyn.perturb_controls(torch.from_numpy(acc), torch.from_numpy(steer),
                                   *eps, to_torch_cfg(cfg).noise)
    assert ta.shape == (C, R, T)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("acc_const,steer_const", [(0.0, 0.0), (0.02, 0.01)])
def test_perturb_controls_beta_on_injected_draws(rng, acc_const, steer_const):
    """Beta noise of the dynamic workload (k_steer 0.05, the 1e-8 floor on
    |u|) on the JAX key chain's Beta draws equals the JAX package's; the
    controls include the exact zeros every solve has (steer at t = 0, acc
    at the last step)."""
    cfg = jc.dynamic_workload(num_reduced=4, num_obs=2, num_prime=20,
                              noise_level=0.2, acc_const_noise=acc_const,
                              steer_const_noise=steer_const)
    C, R, T, it, idx_mpc = 5, 4, 20, 1, 42
    acc, steer = _controls(rng, C, T)
    steer[:, 0] = 0.0
    acc[:, -1] = 0.0
    key, _ = jax.random.split(jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))
    ja, js = jax.vmap(lambda a, s: jdyn.perturb_controls(
        key, a, s, R, cfg.noise))(jnp.asarray(acc), jnp.asarray(steer))
    tcfg = to_torch_cfg(cfg)
    alpha, beta = tdyn.beta_parameters(torch.from_numpy(acc),
                                       torch.from_numpy(steer), tcfg.noise)
    assert alpha.shape == (2, C, T)
    draws = torch.from_numpy(jax_beta(idx_mpc, it, R, alpha.numpy(), beta.numpy()))
    eps_const = torch.from_numpy(jax_draws(cfg, idx_mpc)["eps_const"][it])
    ta, ts = tdyn.perturb_controls(torch.from_numpy(acc), torch.from_numpy(steer),
                                   draws[0], draws[1], eps_const, tcfg.noise)
    assert ta.shape == (C, R, T)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def test_perturb_controls_rejects_beta_noise():
    """Beta noise needs its Beta draws: a noise source that has neither
    replayed draws nor a function to draw them refuses it."""
    cfg = to_torch_cfg(jc.dynamic_workload(num_reduced=2, num_prime=3))
    eps = np.zeros((1, 2, 3), np.float32)
    noise = FixedNoise({"eps_acc": eps, "eps_steer": eps, "eps_const": eps}, "cpu")
    z = torch.zeros(1, 4, 3)            # a chunk of one scenario's 4 candidates
    with pytest.raises(ValueError):
        noisy_controls(cfg, noise, [0], 0, z, z)
    gaussian = to_torch_cfg(jc.static_workload(num_reduced=2, num_prime=3))
    assert noisy_controls(gaussian, noise, [0], 0, z, z)[0].shape == (1, 4, 2, 3)


def test_controls_from_trajectory_matches_jax(rng):
    shape = (7, 50)
    xd = rng.normal(8, 2, shape).astype(np.float32)
    yd = rng.normal(0, 1, shape).astype(np.float32)
    xdd = rng.normal(0, 1, shape).astype(np.float32)
    ydd = rng.normal(0, 1, shape).astype(np.float32)
    ja, js = jdyn.controls_from_trajectory(*map(jnp.asarray, (xd, yd, xdd, ydd)),
                                           0.15, 2.5)
    ta, ts = tdyn.controls_from_trajectory(*map(torch.from_numpy, (xd, yd, xdd, ydd)),
                                           0.15, 2.5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    assert np.all(ta[:, -1].numpy() == 0.0)


def test_constant_velocity_obstacles_matches_jax(rng):
    x0, y0, vx, vy, psi = (rng.normal(0, 5, 3).astype(np.float32) for _ in range(5))
    t = np.linspace(0, 15, 100).astype(np.float32)
    ref = jdyn.constant_velocity_obstacles(*map(jnp.asarray, (x0, y0, vx, vy, psi, t)))
    got = tdyn.constant_velocity_obstacles(*map(torch.from_numpy, (x0, y0, vx, vy, psi, t)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)
