"""The "exact" strategy, the reference-parity path, against the JAX package,
and the JAX functions ported with it: ``linalg.cho_solve_small``,
``kernels.blockwise_mmd_vs_zero`` and ``sampling.gmm_noisy_init_state``.

The exact ``Solver`` and ``FrenetSolver`` run on the JAX solve's draws
(``test_torch_noise.jax_draws``, whose ``z_exact`` are the multivariate
normal draws of the exact inner CEM) and its workspace; their controls
must agree within 1e-3, the JAX package's parity bar
(tests/test_parity.py:132-145), and the risk, the res trace and the CEM
moments at rtol 1e-3 + atol 1e-3.  ``select_reduced_set`` alone, the LU
KKT solve, ``cho_solve_small`` and the GMM initial states are held at
float32 round-off (rtol 1e-4 or tighter); the exact guess QP, whose KKT
matrices are ill-conditioned, against the float64 solution at twice the
JAX package's own error; the blockwise MMD as the JAX package holds its
own against the dense one (tests/test_kernels.py:69-122).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocking_scenarios
from mpc_mmd_tpu import Solver as JSolver
from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import kernels as jkernels
from mpc_mmd_tpu import linalg as jlinalg
from mpc_mmd_tpu import qp as jqp
from mpc_mmd_tpu import reduced_set as jrs
from mpc_mmd_tpu import sampling as jsampling
from mpc_mmd_tpu_torch import FrenetSolver as TFrenetSolver
from mpc_mmd_tpu_torch import Solver as TSolver
from mpc_mmd_tpu_torch import kernels as tkernels
from mpc_mmd_tpu_torch import linalg as tlinalg
from mpc_mmd_tpu_torch import qp as tqp
from mpc_mmd_tpu_torch import reduced_set as trs
from mpc_mmd_tpu_torch import sampling as tsampling
from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, record_solve_draws
from mpc_mmd_tpu_torch.ops import fused_rollout
from test_torch_frenet import (COV0, IDX, MEAN0, _scenario, frenet_cfg,
                               frenet_draws)
from test_torch_noise import jax_draws, to_torch_cfg
from test_torch_solver import COV, INIT, MEAN, _controls

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _exact(cfg):
    return cfg.replace(solve_strategy="exact")


def _solver_cfg(mode, maxiter_cem):
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2, mode=mode)
    return _exact(cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=maxiter_cem),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16, maxiter=3)))


def _held(got, ref, names):
    for name in names:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("mode,maxiter_cem,idx_mpc,scenario", [
    ("mmd_opt", 1, 42, 0), ("mmd_opt", 3, 7, 2), ("cvar", 1, 42, 0)])
def test_exact_solver_matches_jax(mode, maxiter_cem, idx_mpc, scenario):
    cfg = _solver_cfg(mode, maxiter_cem)
    js = JSolver(cfg)
    ws = tqp.workspace_from_numpy({n: np.asarray(getattr(js.ws, n))
                                   for n in js.ws._fields}, "cpu")
    ts = TSolver(to_torch_cfg(cfg), device="cpu", ws=ws,
                 noise=FixedNoise(jax_draws(cfg, idx_mpc), "cpu"))
    xts, yts = blocking_scenarios(js.ws.tot_time, scenario + 1)
    xo, yo = np.asarray(xts[scenario]), np.asarray(yts[scenario])
    ref = js.solve(idx_mpc, jnp.asarray(INIT), jnp.asarray(MEAN), jnp.asarray(COV),
                   jnp.asarray(xo), jnp.asarray(yo), 15.0)
    launches = fused_rollout.launches
    got = ts.solve(idx_mpc, INIT, MEAN, COV, xo, yo, 15.0)
    assert fused_rollout.launches == launches      # CPU: the plain twin
    a_r, s_r = _controls(js.ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(js.ws, cfg, jnp.asarray(got.cx.numpy()),
                         jnp.asarray(got.cy.numpy()))
    assert np.max(np.abs(a_r - a_m)) <= 1e-3
    assert np.max(np.abs(s_r - s_m)) <= 1e-3
    _held(got, ref, ("risk_obs", "res", "res_beta", "mean_param", "cov_param",
                     "sigma"))
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-3, atol=1e-4)
    assert got.res.shape == (maxiter_cem,)


@pytest.mark.parametrize("maxiter_cem", [1, 3])
def test_exact_frenet_solver_matches_jax(maxiter_cem):
    from mpc_mmd_tpu.solver_frenet import FrenetSolver as JFrenetSolver
    cfg = _exact(frenet_cfg("mmd_opt", maxiter_cem))
    js = JFrenetSolver(cfg)
    jframe, tframe, init, xo, yo = _scenario()
    ref = js.solve(IDX, jnp.asarray(init), jnp.asarray(MEAN0), jnp.asarray(COV0),
                   jnp.asarray(xo), jnp.asarray(yo), 10.0, jframe)
    ws = tqp.workspace_from_numpy({n: np.asarray(getattr(js.ws, n))
                                   for n in js.ws._fields}, "cpu")
    ts = TFrenetSolver(to_torch_cfg(cfg), device="cpu", ws=ws,
                       noise=FixedNoise(frenet_draws(cfg, IDX), "cpu"))
    got = ts.solve(IDX, init, MEAN0, COV0, xo, yo, 10.0, tframe)
    for name in ("v_best", "steering_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    _held(got, ref, ("risk_obs", "res", "mean_param", "cov_param"))


def _selection_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    C, M, T, nvar = 5, cfg.risk.num_mother, cfg.horizon.num_prime, cfg.horizon.nvar
    cx = rng.normal(0, 1, (C, M, nvar)).astype(np.float32)
    cy = rng.normal(0, 0.5, (C, M, nvar)).astype(np.float32)
    xr = rng.normal(20, 5, (C, M, T)).astype(np.float32)
    yr = rng.normal(0, 1, (C, M, T)).astype(np.float32)
    return cx, cy, xr, yr


@pytest.mark.parametrize("kernel", ["laplace", "gaussian"])
def test_select_reduced_set_matches_jax(kernel):
    """The exact inner CEM of 5 candidates against the JAX vmap: slots in
    ascending |beta|, the winner's weights, bandwidth, rollouts and the
    residual trace."""
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2, num_prime=20)
    cfg = _exact(cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16, maxiter=4),
        risk=dataclasses.replace(cfg.risk, kernel=kernel)))
    args = _selection_inputs(cfg, 1)
    ref = jax.vmap(lambda a, b, c, d: jrs.select_reduced_set(cfg, a, b, c, d))(
        *map(jnp.asarray, args))
    bc = cfg.beta_cem
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_exact(
        bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite, bc.maxiter)
    got = trs.select_reduced_set(to_torch_cfg(cfg), *map(_t, args), draws)
    for name in ("beta", "sigma", "res", "x_red", "y_red"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the reduced rollouts are mother rollouts, gathered exactly
    xr = args[2]
    for c in range(len(xr)):
        rows = got.x_red[c].numpy()
        assert all(any(np.array_equal(r, m) for m in xr[c]) for r in rows)


def test_exact_selection_without_a_positive_definite_covariance_is_nan():
    """A negative jitter leaves the elites' covariance indefinite: the
    Cholesky factor is NaN in both packages, not an exception, and so are
    the resampled rows and the bandwidth drawn from them."""
    cfg = jc.fastrt_workload(num_reduced=3, num_obs=2, num_prime=20)
    cfg = _exact(cfg.replace(beta_cem=dataclasses.replace(
        cfg.beta_cem, num_samples_cem=16, maxiter=2, cov_jitter=-50.0)))
    args = _selection_inputs(cfg, 2)
    ref = jax.vmap(lambda a, b, c, d: jrs.select_reduced_set(cfg, a, b, c, d))(
        *map(jnp.asarray, args))
    bc = cfg.beta_cem
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_exact(
        bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite, bc.maxiter)
    got = trs.select_reduced_set(to_torch_cfg(cfg), *map(_t, args), draws)
    for name in ("beta", "sigma", "res"):
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=name)
    assert np.isnan(np.asarray(ref.res)[:, -1]).all()


def test_exact_kkt_solve_and_guess_match_jax(rng):
    cfg = _exact(jc.fastrt_workload(num_reduced=3, num_obs=2, num_prime=20))
    jws = jqp.build_workspace(cfg)
    tws = tqp.workspace_from_numpy({n: np.asarray(getattr(jws, n))
                                    for n in jws._fields}, "cpu")
    rhs = rng.normal(0, 3, (7, jws.proj_kkt_x.shape[0])).astype(np.float32)
    for strategy in ("exact", "prefactored"):
        ref = jqp.kkt_solve(jws.proj_kkt_x, jws.proj_kkt_x_inv, jnp.asarray(rhs),
                            strategy)
        got = tqp.kkt_solve(tws.proj_kkt_x, tws.proj_kkt_x_inv, _t(rhs), strategy)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4, err_msg=strategy)
    # the guess KKT matrices are ill-conditioned (smoothness weight 100), so
    # a float32 LU solve is off the float64 solution by ~1e-4 of its scale
    # in either package: the port is held to the float64 solution at twice
    # the JAX package's own error
    params = rng.normal(10, 3, (cfg.cem.num_batch, 8)).astype(np.float32)
    b_eq = jqp.boundary_vectors(cfg, jnp.asarray(INIT))
    ref = jqp.compute_guess(cfg, jws, jnp.asarray(params), *b_eq)
    got = tqp.compute_guess(to_torch_cfg(cfg), tws, _t(params),
                            *(_t(b) for b in b_eq))
    nseg, nvar = cfg.guess.num_segments, cfg.horizon.nvar
    for g, r, lin, kkt, b in zip(got, ref, (jws.G_vx, jws.G_py),
                                 (jws.guess_kkt_x, jws.guess_kkt_y), b_eq):
        p = params[:, :nseg] if lin is jws.G_vx else params[:, nseg:2 * nseg]
        rhs = np.concatenate((-(p.astype(np.float64) @ np.asarray(lin, np.float64)),
                              np.asarray(b, np.float64)), axis=1)
        f64 = np.linalg.solve(np.asarray(kkt, np.float64), rhs.T).T[:, :nvar]
        err_j = np.abs(np.asarray(r) - f64).max()
        assert np.abs(g.numpy() - f64).max() <= 2 * err_j + 1e-6
    singular = torch.zeros(4, 4)
    assert not torch.isfinite(tqp.kkt_solve(singular, singular, torch.ones(2, 4),
                                            "exact")).all()


def test_cho_solve_small_matches_jax(rng):
    A = rng.normal(0, 1, (6, 5, 5))
    A = (A @ A.transpose(0, 2, 1) + 5 * np.eye(5)).astype(np.float32)
    b = rng.normal(0, 1, (6, 5)).astype(np.float32)
    L = jlinalg.cholesky_small(jnp.asarray(A))
    ref = jlinalg.cho_solve_small(L, jnp.asarray(b))
    got = tlinalg.cho_solve_small(_t(np.asarray(L)), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose((_t(A) @ got[..., None])[..., 0].numpy(), b,
                               rtol=1e-4, atol=1e-4)


def test_blockwise_mmd_matches_jax_and_dense(rng):
    n = 3000
    beta = rng.dirichlet(np.ones(n)).astype(np.float32)
    cost = np.abs(rng.normal(0, 1, n)).astype(np.float32)
    dense = float(tkernels.mmd_vs_zero(_t(beta), _t(cost), 2.0, 1000.0))
    for block in (512, 1024):          # 1024 pads the last block
        got = float(tkernels.blockwise_mmd_vs_zero(_t(beta), _t(cost), 2.0, 1000.0,
                                                   block=block))
        ref = float(jkernels.blockwise_mmd_vs_zero(jnp.asarray(beta), jnp.asarray(cost),
                                                   2.0, 1000.0, block=block))
        assert got == pytest.approx(dense, rel=1e-4, abs=1e-3)
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-4)


@pytest.mark.parametrize("kind", ["laplace", "gaussian", "matern52"])
def test_blockwise_mmd_batched_matches_jax(rng, kind):
    B, n = (2, 3), 700
    beta = rng.normal(0, 1, B + (n,)).astype(np.float32)
    cost = np.abs(rng.normal(0, 1, B + (n,))).astype(np.float32)
    sig = (1.0 + rng.random(B)).astype(np.float32)
    for s_t, s_j in ((_t(sig), jnp.asarray(sig)), (2.0, 2.0)):
        got = tkernels.blockwise_mmd_vs_zero(_t(beta), _t(cost), s_t, 1000.0,
                                             block=256, kind=kind)
        ref = jkernels.blockwise_mmd_vs_zero(jnp.asarray(beta), jnp.asarray(cost),
                                             s_j, 1000.0, block=256, kind=kind)
        dense = tkernels.mmd_vs_zero(_t(beta), _t(cost), s_t, 1000.0, kind=kind)
        assert got.shape == B
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError):
        tkernels.blockwise_mmd_vs_zero(_t(beta), _t(cost)[..., :-1], 2.0, 1000.0)
    # 1-d samples under a batch of bandwidths: one MMD each
    b1, c1 = _t(beta[0, 0]), _t(cost[0, 0])
    sig_b = torch.tensor([0.7, 1.3, 2.9])
    got = tkernels.blockwise_mmd_vs_zero(b1, c1, sig_b, 1000.0, block=256, kind=kind)
    ref = jkernels.blockwise_mmd_vs_zero(jnp.asarray(beta[0, 0]), jnp.asarray(cost[0, 0]),
                                         jnp.asarray(sig_b.numpy()), 1000.0,
                                         block=256, kind=kind)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-3)


def _jax_gmm_draws(idx_mpc, n):
    """The JAX function's draws: one key for the normals and the modes."""
    key = jax.random.split(jax.random.PRNGKey(idx_mpc))[0]
    z = jax.random.normal(key, (n, 4))
    modes = jax.random.choice(key, jnp.asarray([1, 2, 3]), (n,),
                              p=jnp.asarray(jsampling.GMM_INIT_PROBS))
    return np.asarray(z), np.asarray(modes)


@pytest.mark.parametrize("idx_mpc,n", [(0, 10), (3, 17), (11, 40), (5, 4)])
def test_gmm_noisy_init_state_matches_jax(idx_mpc, n):
    """The JAX function on its own key against the port on the same draws;
    small n leaves some mode short of its share, which repeats member 0."""
    state = (4.0, -1.5, 6.0, 0.5)
    ref = jsampling.gmm_noisy_init_state(idx_mpc, *map(jnp.float32, state), n)
    z, modes = _jax_gmm_draws(idx_mpc, n)
    noise = FixedNoise({"gmm_z": z, "gmm_modes": modes}, "cpu")
    got = tsampling.gmm_noisy_init_state(
        *noise.gmm_init_draws(idx_mpc, n, tsampling.GMM_INIT_PROBS),
        *map(torch.tensor, state))
    for g, r in zip(got, ref):
        assert g.shape == (n,)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    own = TorchNoise(torch.Generator(), "cpu").gmm_init_draws(idx_mpc, n, (0.4, 0.2, 0.4))
    assert own[0].shape == (n, 4) and set(own[1].tolist()) <= {1, 2, 3}


def test_exact_draws_are_recorded_and_replayed():
    """record_solve_draws records the exact family; a replay of the recorded
    draws gives the recording solve's result."""
    cfg = to_torch_cfg(_solver_cfg("mmd_opt", 2))
    arrays, record = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg, 4)
    bc = cfg.beta_cem
    assert arrays["z_exact"].shape == (bc.maxiter, bc.num_samples_cem - bc.num_ellite,
                                       cfg.risk.num_mother + 1)
    np.testing.assert_array_equal(
        arrays["z_exact"], TorchNoise(torch.Generator(), "cpu").inner_exact(
            bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite, bc.maxiter).z)
    t = np.linspace(0.0, 15.0, 100)
    args = (INIT, MEAN, COV, np.stack([8 + 0 * t, 13 + 0 * t]),
            np.stack([1.75 + 0 * t, 0.6 + 0 * t]), 15.0)
    first = TSolver(cfg, device="cpu", noise=TorchNoise(torch.Generator(), "cpu")).solve(4, *args)
    again = TSolver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu", record)).solve(4, *args)
    for name in ("cx", "cy", "risk_obs", "res", "beta"):
        assert torch.equal(getattr(first, name), getattr(again, name)), name
    assert np.isfinite(first.cx.numpy()).all()
