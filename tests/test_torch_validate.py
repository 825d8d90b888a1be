"""PyTorch port vs JAX package: the Monte-Carlo validator.

Both validators get identical (cx, cy, init_state, obstacles) and the port
replays the JAX key chain's own draws (``split(PRNGKey(seed), S)`` per
solve, then ``split(key, 3)``; validate.py:45,127) through ``FixedNoise``.
Both roll in plain float32 in the same expression order, so collision and
lane counts and collision fractions must be equal; the rollouts differ
only in the last ulps of torch's and XLA's sin/cos/tan, which flips a
count only for a rollout that grazes an ellipse or a lane bound to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu.dynamics import controls_from_trajectory as j_controls
from mpc_mmd_tpu.qp import build_workspace as j_build_workspace
from mpc_mmd_tpu.validate import make_validator_core as j_core
from mpc_mmd_tpu_torch.dynamics import mc_beta_parameters
from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, sample_beta
from mpc_mmd_tpu_torch.qp import build_workspace
from mpc_mmd_tpu_torch.validate import make_validator, make_validator_core
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)

INIT = np.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], np.float32)


def jax_mc_draws(cfg, ws, cx, cy, seed, n_mc):
    """The JAX validator's draws for solves (cx, cy), as FixedNoise arrays."""
    T = cfg.horizon.num_prime
    keys = jax.random.split(jax.random.PRNGKey(seed), cx.shape[0])
    out = {n: [] for n in ("mc_eps_acc", "mc_eps_steer", "mc_eps_const",
                           "mc_beta")}
    for key, x, y in zip(keys, cx, cy):
        k1, k2, k3 = jax.random.split(key, 3)
        out["mc_eps_const"].append(jax.random.normal(k3, (n_mc, T)))
        if cfg.noise.kind == "gaussian":
            out["mc_eps_acc"].append(jax.random.normal(k1, (n_mc, T)))
            out["mc_eps_steer"].append(jax.random.normal(k2, (n_mc, T)))
            continue
        acc, steer = j_controls((ws.Pdot @ x)[None], (ws.Pdot @ y)[None],
                                (ws.Pddot @ x)[None], (ws.Pddot @ y)[None],
                                cfg.horizon.dt, cfg.vehicle.wheel_base)
        acc, steer = jnp.abs(acc[0][:T]), jnp.abs(steer[0][:T])
        nz = cfg.noise
        out["mc_beta"].append(jnp.stack((
            jax.random.beta(k1, nz.beta_a * acc, nz.beta_b * acc, (n_mc, T)),
            jax.random.beta(k2, nz.beta_a * steer + 1e-5,
                            nz.beta_b * steer + 1e-5, (n_mc, T)))))
    return {n: np.asarray(jnp.stack(v)) for n, v in out.items() if v}


def _solves(ws, S, rng):
    """S straight-ish paths near y = 1.75 at about 5 m/s, fitted to the
    Bernstein basis, with a different speed and drift each."""
    t = np.linspace(0.0, 15.0, 100)
    P = np.asarray(ws.P, np.float64)
    cx, cy = [], []
    for i in range(S):
        v = 5.0 + 0.4 * i
        cx.append(np.linalg.lstsq(P, v * t + 0.05 * rng.normal() * t ** 2,
                                  rcond=None)[0])
        cy.append(np.linalg.lstsq(P, 1.75 + 0.02 * (i - 1) * t, rcond=None)[0])
    return np.asarray(cx, np.float32), np.asarray(cy, np.float32)


def _obstacles(S, num):
    """Per solve: one obstacle whose ellipse edge lies near the ego's path
    at x = 12 + 2i, one far off, so the counts are partial."""
    xo = np.zeros((S, 2, num), np.float32)
    yo = np.zeros((S, 2, num), np.float32)
    for i in range(S):
        xo[i, 0], yo[i, 0] = 12.0 + 2.0 * i, 1.75 - 2.6 - 0.05 * i
        xo[i, 1], yo[i, 1] = 300.0, -1.75
    return xo, yo


@pytest.mark.parametrize("noise", ["gaussian", "beta"])
def test_validator_matches_jax(rng, noise):
    kw = dict(noise=noise, noise_level=0.2 if noise == "gaussian" else 0.4,
              acc_const_noise=0.05, steer_const_noise=0.02)
    cfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=30, mode="cvar",
                             **kw)
    jws = j_build_workspace(cfg)
    S, n_mc, seed = 4, 300, 7
    cx, cy = _solves(jws, S, rng)
    xo, yo = _obstacles(S, cfg.horizon.num)
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    ref = j_core(cfg, jws, n_mc)(*map(jnp.asarray, (cx, cy, INIT, xo, yo)), keys)

    tcfg = to_torch_cfg(cfg)
    arrays = jax_mc_draws(cfg, jws, jnp.asarray(cx), jnp.asarray(cy), seed, n_mc)
    # chunk 3 splits the 4 solves, so the per-row draws cross a chunk
    core = make_validator_core(tcfg, build_workspace(tcfg, "cpu"), n_mc,
                               FixedNoise(arrays, "cpu"), chunk=3)
    got = core(cx, cy, INIT, xo, yo, seed, range(S))

    for name in ("coll_count", "lane_count", "coll_fraction"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert got.coll_count.dtype == torch.int32
    # the setup exercises partial collisions and lane violations
    assert 0 < int(got.coll_count.max()) < n_mc
    assert int(got.lane_count.max()) > 0


def test_validator_draws_do_not_depend_on_chunking():
    """TorchNoise draws per (seed, row): chunk sizes, batch validation and a
    lone solve keyed by its row give the same counts; another seed does
    not."""
    cfg = to_torch_cfg(jc.static_workload(num_reduced=3, num_obs=2,
                                          num_prime=30, noise_level=0.3,
                                          steer_const_noise=0.02))
    ws = build_workspace(cfg, "cpu")
    S, n_mc = 5, 200
    cx, cy = _solves(ws, S, np.random.default_rng(2))
    xo, yo = _obstacles(S, cfg.horizon.num)
    noise = TorchNoise(torch.Generator(), "cpu")
    whole = make_validator(cfg, ws, n_mc, noise, chunk=256)(cx, cy, INIT, xo, yo, 3)
    split = make_validator(cfg, ws, n_mc, noise, chunk=2)(cx, cy, INIT, xo, yo, 3)
    lone = make_validator_core(cfg, ws, n_mc, noise)(cx[3:4], cy[3:4], INIT,
                                                     xo[3:4], yo[3:4], 3, [3])
    for a, b in zip(whole, split):
        assert torch.equal(a, b)
    for a, b in zip(lone, whole):
        assert torch.equal(a, b[3:4])
    assert 0 < int(whole.coll_count.max()) < n_mc
    other = make_validator(cfg, ws, n_mc, noise)(cx, cy, INIT, xo, yo, 4)
    assert not torch.equal(other.coll_fraction, whole.coll_fraction)


def test_beta_draws_at_zero_parameters_match_jax():
    """The validator's acc channel has no floor: where acc is exactly 0 it
    asks for Beta(0, 0).  jax.random.beta returns NaN there and 0 for
    Beta(0, b > 0); the port's log-space sampler returns the same."""
    key = jax.random.PRNGKey(0)
    g = torch.Generator().manual_seed(0)
    for b in (0.0, 5e-6, 5.0):
        ref = np.asarray(jax.random.beta(key, jnp.zeros(64), jnp.full(64, b), (64,)))
        got = sample_beta(torch.zeros(64), torch.full((64,), b), g).numpy()
        if b == 0.0:
            assert np.all(np.isnan(ref)) and np.all(np.isnan(got))
        else:
            np.testing.assert_array_equal(got, ref)
            assert np.all(got == 0.0)
    alpha, beta = mc_beta_parameters(torch.zeros(3), torch.zeros(3),
                                     to_torch_cfg(jc.dynamic_workload()).noise)
    assert torch.all(alpha[0] == 0) and torch.all(beta[0] == 0)
    assert torch.all(alpha[1] == 1e-5 * torch.ones(3).float())


def test_nan_rollouts_count_as_clear():
    """A NaN draw (Beta(0, 0) at acc = 0) turns its rollout NaN from that
    step on, and the comparisons with NaN are false, so the rollout counts
    as never colliding, as in the JAX validator."""
    cfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=30,
                             noise="beta", noise_level=0.2)
    tcfg = to_torch_cfg(cfg)
    ws = build_workspace(tcfg, "cpu")
    n_mc, T = 40, 30
    cx, cy = _solves(ws, 1, np.random.default_rng(0))
    xo = np.full((1, 2, 100), 300.0, np.float32)
    xo[0, 0] = 10.0                       # in the ego's path: all collide
    yo = np.full((1, 2, 100), 1.75, np.float32)
    beta = np.full((1, 2, n_mc, T), 0.5, np.float32)
    beta[0, 0, :7, 0] = np.nan            # 7 rollouts poisoned from t = 0
    arrays = {"mc_beta": beta, "mc_eps_const": np.zeros((1, n_mc, T), np.float32)}
    got = make_validator(tcfg, ws, n_mc, FixedNoise(arrays, "cpu"))(
        cx, cy, INIT, xo, yo)
    assert int(got.coll_count[0]) == n_mc - 7
    assert float(got.coll_fraction[0]) == pytest.approx((n_mc - 7) / n_mc)
