"""The whole slice: the port's Solver vs the JAX package's, mmd_opt mode.

Both packages solve the same tie-free blocking scenarios
(tests/conftest.py) on the identical workspace, and the port replays the
JAX solve's random draws through ``FixedNoise``.

After one outer iteration the returned controls must agree within 1e-3,
the JAX package's own parity bar (tests/test_parity.py:132-145).  After
three iterations the res trace and the risk agree at rtol 1e-3 + atol 1e-3.
That holds only while no argsort meets a near-tie that float32 round-off
resolves differently in the two packages: once one does, a different
candidate or sample wins and the two solves part ways, equally good but no
longer equal, and the comparison would have to become one of solve quality
(tests/test_parity.py explains why for the reference).  The blocking
scenarios keep every candidate's risk distinct, which is why three
iterations still agree.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocking_scenarios
from mpc_mmd_tpu import Solver as JSolver
from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import dynamics as jdyn
from mpc_mmd_tpu_torch import Solver as TSolver
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from test_torch_noise import jax_beta, jax_draws, to_torch_cfg

torch.set_num_threads(1)

INIT = np.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], np.float32)
MEAN = np.asarray([15.0] * 4 + [0.0] * 4, np.float32)
COV = np.diag([20.0] * 4 + [100.0] * 4).astype(np.float32)


def _cfg(maxiter_cem, kernel="laplace"):
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2)
    return cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=maxiter_cem),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                     maxiter=3),
        risk=dataclasses.replace(cfg.risk, kernel=kernel))


def _solve_both(maxiter_cem, idx_mpc, scenario, kernel="laplace"):
    cfg = _cfg(maxiter_cem, kernel)
    js = JSolver(cfg)
    ws = {n: np.asarray(getattr(js.ws, n)) for n in js.ws._fields}
    ts = TSolver(to_torch_cfg(cfg), device="cpu",
                 noise=FixedNoise(jax_draws(cfg, idx_mpc), "cpu"),
                 ws=workspace_from_numpy(ws, "cpu"))
    xts, yts = blocking_scenarios(js.ws.tot_time, scenario + 1)
    xo, yo = np.asarray(xts[scenario]), np.asarray(yts[scenario])
    ref = js.solve(idx_mpc, jnp.asarray(INIT), jnp.asarray(MEAN),
                   jnp.asarray(COV), jnp.asarray(xo), jnp.asarray(yo), 15.0)
    got = ts.solve(idx_mpc, INIT, MEAN, COV, xo, yo, 15.0)
    return cfg, js.ws, ref, got


def _controls(ws, cfg, cx, cy):
    T = cfg.horizon.num_prime
    a, s = jdyn.controls_from_trajectory(
        (ws.Pdot @ cx)[None], (ws.Pdot @ cy)[None], (ws.Pddot @ cx)[None],
        (ws.Pddot @ cy)[None], cfg.horizon.dt, cfg.vehicle.wheel_base)
    return np.asarray(a[0][:T]), np.asarray(s[0][:T])


@pytest.mark.parametrize("idx_mpc,scenario", [(42, 0), (7, 3)])
def test_one_outer_iteration_matches_jax(idx_mpc, scenario):
    _assert_one_iteration(*_solve_both(1, idx_mpc, scenario))


@pytest.mark.parametrize("idx_mpc,scenario", [(42, 0), (7, 3)])
def test_one_outer_iteration_of_the_gaussian_kernel_matches_jax(idx_mpc, scenario):
    """The gaussian MMD kernel (squared-L2 distances) through the solve."""
    _assert_one_iteration(*_solve_both(1, idx_mpc, scenario, "gaussian"))


@pytest.mark.parametrize("idx_mpc,scenario", [(42, 0), (7, 3)])
def test_one_outer_iteration_of_the_matern52_kernel_matches_jax(
        monkeypatch, idx_mpc, scenario):
    """matern52 mixes the L1 radius with the squared-L2 term, and its inner
    CEM turns on last-ulp differences of the selection's inputs and of the
    squared-L2 matrix D2.  Those are round-off: the JAX package's own risk
    at (42, 0) moves from -993.2 to -964.7 when D2 is materialised instead
    of fused into its consumer.  So the JAX solve hands its selection inputs
    and its D2 over, and the port's selection runs on them, the candidates
    matched by their coefficients (the projection residuals that order the
    candidates are round-off too).  Everything else is the port's own, held
    at the one-iteration bar of the other kernels."""
    import jax
    import mpc_mmd_tpu.reduced_set as j_rs
    import mpc_mmd_tpu.solver as j_solver
    import mpc_mmd_tpu_torch.reduced_set as t_rs
    import mpc_mmd_tpu_torch.solver as t_solver

    seen = {}
    j_select, j_l2sq = j_solver.select_reduced_set_batched, j_rs.pairwise_l2sq
    t_select = t_solver.select_reduced_set_batched

    def j_select_seen(cfg, *inputs, **kw):
        jax.debug.callback(lambda *a: seen.update(inputs=a), *inputs)
        return j_select(cfg, *inputs, **kw)

    def j_l2sq_seen(A, B):
        d2 = j_l2sq(A, B)
        jax.debug.callback(lambda d: seen.update(d2=d), d2)
        return d2

    t_distances = t_rs.distance_matrices

    def t_select_on_jax_inputs(cfg, cx, cy, xr, yr, draws, selection=None,
                               distances=None, fixed=None):
        jax.effects_barrier()
        j_cx = np.asarray(seen["inputs"][0])
        gap = np.abs(cx.numpy()[:, None] - j_cx[None]).max(axis=(2, 3))
        perm = gap.argmin(axis=1)
        assert sorted(perm) == list(range(len(perm)))
        assert gap.min(axis=1).max() <= 1e-2
        d2 = torch.from_numpy(np.asarray(seen["d2"])[perm])
        # the port's D from the JAX inputs, its D2 the JAX solve's
        monkeypatch.setattr(t_rs, "distance_matrices",
                            lambda cx, cy, kind: (t_distances(cx, cy, kind)[0], d2))
        return t_select(cfg, *(torch.from_numpy(np.asarray(v)[perm])
                               for v in seen["inputs"]), draws, selection, fixed=fixed)

    monkeypatch.setattr(j_solver, "select_reduced_set_batched", j_select_seen)
    monkeypatch.setattr(j_rs, "pairwise_l2sq", j_l2sq_seen)
    monkeypatch.setattr(t_solver, "select_reduced_set_batched",
                        t_select_on_jax_inputs)
    _assert_one_iteration(*_solve_both(1, idx_mpc, scenario, "matern52"))


@pytest.mark.parametrize("selection", ["xt", "g"])
def test_one_outer_iteration_of_the_xt_and_g_selections_matches_jax(
        monkeypatch, selection):
    """MPC_MMD_SELECTION=xt (K1 and the lane-major K2) and =g (K1 and K2)
    through the whole solve, both packages reading it at call time."""
    monkeypatch.setenv("MPC_MMD_SELECTION", selection)
    _assert_one_iteration(*_solve_both(1, 42, 0))


@functools.lru_cache(maxsize=None)
def _record_cell_jax(N):
    """The JAX solve of one outer iteration of the record's static cell at
    N (Beta noise 0.3) at a cut budget (24 candidates, inner CEM 16 x 2), on
    the first blocking scenario; computed once per N for both selections."""
    cfg = jc.static_workload(num_reduced=N, num_obs=2, noise="beta", noise_level=0.3)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=1),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                   maxiter=2))
    js = JSolver(cfg)
    xts, yts = blocking_scenarios(js.ws.tot_time, 1)
    xo, yo = np.asarray(xts[0]), np.asarray(yts[0])
    ref = js.solve(42, jnp.asarray(INIT), jnp.asarray(MEAN), jnp.asarray(COV),
                   jnp.asarray(xo), jnp.asarray(yo), 15.0)
    return cfg, js.ws, ref, xo, yo


@pytest.mark.parametrize("N", [5, 15])
@pytest.mark.parametrize("selection", ["xla", "fused"])
def test_one_outer_iteration_of_the_record_cells_matches_jax(monkeypatch, N, selection):
    """The JAX record's static acceptance cells at N = 5 and N = 15 (M = 25
    and 225 mother rollouts, Beta noise 0.3), the port's "xla" and "fused"
    selections against the JAX package's default one on its own draws: the
    controls within 1e-3 and the risks, CEM moments and weights at the
    bounds of tests/test_torch_modes.py's Beta case (rtol 1e-3 + atol 1e-3;
    beta rtol 1e-3 + atol 1e-4)."""
    monkeypatch.delenv("MPC_MMD_SELECTION", raising=False)
    monkeypatch.delenv("MPC_MMD_FUSED_CEM", raising=False)
    cfg, ws, ref, xo, yo = _record_cell_jax(N)
    monkeypatch.setenv("MPC_MMD_SELECTION", selection)
    ts = TSolver(to_torch_cfg(cfg), device="cpu",
                 noise=FixedNoise(jax_draws(cfg, 42), "cpu", jax_beta),
                 ws=workspace_from_numpy({n: np.asarray(getattr(ws, n))
                                          for n in ws._fields}, "cpu"))
    got = ts.solve(42, INIT, MEAN, COV, xo, yo, 15.0)
    a_r, s_r = _controls(ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(ws, cfg, jnp.asarray(got.cx.numpy()),
                         jnp.asarray(got.cy.numpy()))
    assert np.max(np.abs(a_r - a_m)) <= 1e-3
    assert np.max(np.abs(s_r - s_m)) <= 1e-3
    for name in ("risk_obs", "risk_lane", "mean_param", "cov_param", "res", "sigma"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    assert got.beta.shape == (N,)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-3, atol=1e-4)


def _assert_one_iteration(cfg, ws, ref, got):
    a_r, s_r = _controls(ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(ws, cfg, jnp.asarray(got.cx.numpy()),
                         jnp.asarray(got.cy.numpy()))
    assert np.max(np.abs(a_r - a_m)) <= 1e-3
    assert np.max(np.abs(s_r - s_m)) <= 1e-3
    for name in ("risk_obs", "mean_param", "cov_param", "sigma", "res"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, err_msg=name)
    # the best candidate's projection residual is float32 round-off (~1e-6):
    # held absolutely, at the residual bound of tests/test_parity.py:111
    np.testing.assert_allclose(got.res_2.numpy(), np.asarray(ref.res_2),
                               atol=1e-4)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-3, atol=1e-4)
    assert float(got.beta.sum()) == pytest.approx(1.0, abs=1e-3)


def test_three_outer_iterations_match_jax():
    cfg, ws, ref, got = _solve_both(3, 42, 1)
    assert got.res.shape == (3,) and got.res_beta.shape == (3,)
    for name in ("res", "risk_obs", "res_beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    for name in ("cx", "cy", "beta", "mean_param", "cov_param"):
        assert np.all(np.isfinite(getattr(got, name).numpy())), name


def test_solver_rejects_what_is_not_ported(monkeypatch):
    """The det mode and other rollout backends raise NotImplementedError;
    scenario chunks (argument or MPC_MMD_SCENARIO_CHUNK) and the exact
    strategy build, and the "xt" and "g" selections solve."""
    tcfg = to_torch_cfg(_cfg(1))
    for bad in (lambda: tcfg.with_risk_mode("det"),
                lambda: tcfg.replace(rollout_backend="pallas")):
        with pytest.raises(NotImplementedError):
            TSolver(bad(), device="cpu")
    with pytest.raises(ValueError):
        TSolver(tcfg.replace(solve_strategy="bogus"), device="cpu")
    assert TSolver(tcfg, device="cpu", scenario_chunk=2).scenario_chunk == 2
    monkeypatch.setenv("MPC_MMD_SCENARIO_CHUNK", "4")
    assert TSolver(tcfg, device="cpu").scenario_chunk == 4
    monkeypatch.delenv("MPC_MMD_SCENARIO_CHUNK")
    exact = TSolver(tcfg.replace(solve_strategy="exact"), device="cpu")
    assert exact.cfg.solve_strategy == "exact" and exact.scenario_chunk == 1
    solver = TSolver(tcfg, device="cpu")
    t = solver.ws.tot_time
    xo, yo = torch.stack([8.0 + 0 * t, 13.0 + 0 * t]), torch.stack([1.75 + 0 * t] * 2)
    # the "xt" and "g" selections are ported: the solve runs, its weights
    # sum to 1
    for sel in ("xt", "g"):
        monkeypatch.setenv("MPC_MMD_SELECTION", sel)
        r = solver.solve(0, INIT, MEAN, COV, xo, yo, 15.0)
        assert bool(torch.isfinite(r.cx).all()) and bool(torch.isfinite(r.risk_obs))
        assert float(r.beta.sum()) == pytest.approx(1.0, abs=1e-3)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """Solver, build_workspace, static_grid and dynamic_cutin run on the
    card unless asked for the CPU: without a card their default raises a
    RuntimeError that names device="cpu", and nothing runs on the CPU."""
    from mpc_mmd_tpu_torch import scenarios
    from mpc_mmd_tpu_torch.qp import build_workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = to_torch_cfg(_cfg(1))
    for call in (lambda: TSolver(tcfg), lambda: build_workspace(tcfg),
                 lambda: TSolver(tcfg, device="cuda:0"),
                 lambda: scenarios.static_grid(tcfg, 2),
                 lambda: scenarios.dynamic_cutin(tcfg, 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert TSolver(tcfg, device="cpu").ws.P.device.type == "cpu"
