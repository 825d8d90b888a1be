"""PyTorch port vs JAX package: rollout (K4's plain twin), noise, controls.

Gaussian and Beta control noise are compared on the JAX key chain's own
draws (``test_torch_noise.jax_draws`` and ``jax_beta``).

Tolerance: atol 1e-5 on rollout positions, the bound tests/test_ops.py
holds the Pallas rollout to against the scan, plus rtol 1e-6: torch's and
XLA's CPU sin/cos/tan differ in the last ulp, and after 50 steps positions
of 30 m (where one float32 ulp is 2e-6) differ by a few ulps.  K4n's
noisy rollouts (``ops.noisy_rollout``, on the CPU its plain version) are
held to rtol 1e-5 + atol 1e-4 of the JAX package's batched_rollouts, the
bar chip_smoke.py holds K4 to its plain loop: the noisy controls agree
within 1e-6 (the perturb tests below) and XLA contracts the steps'
multiply-adds, which the port's loop rounds apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import dynamics as jdyn
from mpc_mmd_tpu import solver as jsolver
from mpc_mmd_tpu.ops import fused_rollout as j_fused_rollout
from mpc_mmd_tpu_torch import dynamics as tdyn
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops import fused_rollout, noisy_rollout
from mpc_mmd_tpu_torch.ops.rollout import noisy_rollout_plain
from mpc_mmd_tpu_torch.solver import batched_rollouts, noisy_controls, rollout_draws
from test_torch_noise import jax_beta, jax_draws, to_torch_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rng():
    """This file's own generator, seeded as tests/conftest.py's session one.

    The session generator is shared by every file a test worker runs, so
    under ``--dist loadfile`` its state here depended on the files the
    worker ran before: the rollouts of test_rollout_matches_scan_and_pallas_kernel
    then drew other controls than when the file runs alone (at some states
    one float32 y position parts from the scan's by more than its atol).
    """
    return np.random.default_rng(0)


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
        noisy_controls(cfg, noise, noise.keys([0], 1)[:, 0], z, z)
    gaussian = to_torch_cfg(jc.static_workload(num_reduced=2, num_prime=3))
    assert noisy_controls(gaussian, noise, noise.keys([0], 1)[:, 0], z, z)[0].shape == (
        1, 4, 2, 3)


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


@pytest.mark.parametrize("kind", ["gaussian", "beta"])
@pytest.mark.parametrize("mother", [True, False])
@pytest.mark.parametrize("per_lane", [False, True])
def test_noisy_rollout_matches_jax_batched_rollouts(kind, mother, per_lane):
    """K4n's plain entry on the JAX key chain's draws (``FixedNoise`` through
    ``solver.rollout_draws``) against the JAX package's batched_rollouts with
    the closed-over key of the same outer iteration (solver.py:101-135):
    gaussian and Beta noise, R^2 mother rollouts and R, one initial state
    and a state per rollout (the on-road solve's)."""
    rng = np.random.default_rng(11)
    make = jc.fastrt_workload if kind == "gaussian" else jc.dynamic_workload
    cfg = make(num_reduced=4, num_obs=2, num_prime=20, noise=kind, noise_level=0.2,
               mode="mmd_opt" if mother else "cvar", acc_const_noise=0.02,
               steer_const_noise=0.01)
    tcfg = to_torch_cfg(cfg)
    C, R, T, it, idx_mpc = 5, 4, 20, 1, 42
    acc, steer = _controls(rng, C, T)
    steer[:, 0] = 0.0
    acc[:, -1] = 0.0
    n = R * R if mother else R
    state0 = np.asarray([0.0, 1.75, 5.0, 0.0, 0.0], np.float32)
    if per_lane:
        state0 = (state0 + rng.normal(0, 0.3, (n, 5))).astype(np.float32)
    key, _ = jax.random.split(jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))
    jx, jy = jsolver.batched_rollouts(cfg, "xla", key, jnp.asarray(acc), jnp.asarray(steer),
                                      jnp.asarray(state0), mother)
    noise = FixedNoise(jax_draws(cfg, idx_mpc), "cpu", jax_beta)
    keys = noise.keys([idx_mpc], it + 1)[:, it]
    a_t, s_t = torch.from_numpy(acc)[None], torch.from_numpy(steer)[None]
    draws = rollout_draws(tcfg, noise, keys, a_t, s_t)
    before = noisy_rollout.launches
    tx, ty = noisy_rollout(a_t, s_t, *draws, torch.from_numpy(state0), tcfg.noise,
                           cfg.horizon.dt, cfg.vehicle.wheel_base, mother)
    assert noisy_rollout.launches == before     # CPU tensors take the plain version
    assert tx.shape == (1, C, n, T)
    for t, r in ((tx, jx), (ty, jy)):
        np.testing.assert_allclose(t[0].numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
    # the plain version is the solver's chain, bit for bit
    cx, cy = batched_rollouts(tcfg, *noisy_controls(tcfg, noise, keys, a_t, s_t),
                              torch.from_numpy(state0), mother)
    assert torch.equal(tx, cx) and torch.equal(ty, cy)


def test_noisy_rollout_rejects_bad_shapes():
    cfg = to_torch_cfg(jc.fastrt_workload(num_reduced=2, num_prime=3))
    acc = torch.zeros(1, 4, 3)
    d, eps, s0 = torch.zeros(1, 1, 2, 3), torch.zeros(1, 1, 2, 3), torch.zeros(5)
    args = (cfg.noise, 0.15, 2.5, True)
    with pytest.raises(ValueError):          # controls not (N, C, T)
        noisy_rollout(acc[0], acc[0], d, d, eps, s0, *args)
    with pytest.raises(ValueError):          # draws of another R
        noisy_rollout(acc, acc, d, d, torch.zeros(1, 1, 3, 3), s0, *args)
    with pytest.raises(ValueError):          # gaussian draws a candidate
        noisy_rollout(acc, acc, torch.zeros(1, 4, 2, 3), torch.zeros(1, 4, 2, 3), eps,
                      s0, *args)
    with pytest.raises(ValueError):          # a state per lane of another count
        noisy_rollout(acc, acc, d, d, eps, torch.zeros(2, 5), *args)
    x, _ = noisy_rollout_plain(acc, acc, d, d, eps, torch.zeros(4, 5), *args)
    assert x.shape == (1, 4, 4, 3)


# every path's K4n launch: (scenarios, C, R, lanes a candidate, draws' dc,
# T): fastrt x 1, 4, 8 (E1, E4, E8), Path A mother x 1, 4 (A, EA4) and Path
# B's R under Beta noise x 1, 4 (B, EB4), Path D mother and its other
# modes, F5 and F15 (Beta, mother)
K4N_PATHS = [(1, 64, 10, 100, 1, 50), (4, 64, 10, 100, 1, 50), (8, 64, 10, 100, 1, 50),
             (1, 100, 10, 100, 100, 50), (4, 100, 10, 100, 100, 50),
             (1, 100, 10, 10, 100, 50), (4, 100, 10, 10, 100, 50),
             (1, 100, 4, 16, 1, 50), (1, 100, 4, 4, 1, 50), (1, 100, 5, 25, 100, 50),
             (1, 100, 15, 225, 100, 50)]


@pytest.mark.parametrize("N,C,R,per,dc,T", K4N_PATHS)
def test_noisy_smem_at_every_path_shape(N, C, R, per, dc, T):
    """K4n's block (32 lanes up to 12,800 lanes a launch, 64 up to 25,600,
    else 160) stages
    its candidates' control rows, the draw slabs of its scenarios
    (gaussian) or candidates (Beta) and eps_const within the 227 KB a block
    may take: what its lanes touch, and at most 40 floats more."""
    from mpc_mmd_tpu_torch.ops.rollout import MAX_SMEM, noisy_lanes, noisy_smem_bytes
    LB = noisy_lanes(N * C * per)
    lanes = N * C * per
    assert LB == (32 if lanes <= 12800 else 64 if lanes <= 25600 else 160)
    smem = noisy_smem_bytes(N, C, R, per, dc, T)
    # the candidates and scenarios LB lanes starting at a multiple of LB touch
    starts = range(0, N * C * per, LB)
    nc = max((l0 + LB - 1) // per - l0 // per + 1 for l0 in starts)
    ns = max((l0 + LB - 1) // (C * per) - l0 // (C * per) + 1 for l0 in starts)
    nd = nc if dc > 1 else ns
    need = 2 * LB * 51 + 2 * nc * T + (2 * nd + ns) * R * T
    assert 4 * need <= smem <= min(MAX_SMEM, 4 * (need + 40))


def test_noisy_smem_values_and_refusal():
    from mpc_mmd_tpu_torch.ops.rollout import MAX_SMEM, noisy_smem_bytes
    # fastrt: slabs 2 x 32 x 51, two candidates' rows (2 x 104), and the
    # draws and eps of one scenario (3 x 508: 6,400 lanes, a multiple of 32)
    assert noisy_smem_bytes(1, 64, 10, 100, 1, 50) == 4 * (3264 + 4 + 208 + 3 * 508)
    # K4's T <= 900 is not K4n's: its staging passes 227 KB there
    assert noisy_smem_bytes(1, 64, 10, 100, 1, 900) > MAX_SMEM
    assert noisy_smem_bytes(1, 64, 10, 100, 1, 300) <= MAX_SMEM
