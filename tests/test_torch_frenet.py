"""The port's Frenet toolkit, obstacle-term and Frenet projection, desired-lane
risks and FrenetSolver against the JAX package, on identical inputs.

Tolerances: the toolkit's functions at float32 round-off (rtol 1e-5, atol
1e-5; ``interp`` exactly on knots and at the ends); ``smooth_path`` at atol
1e-4 plus rtol 1e-6 (ten rounds of 601-long float32 dot products, summed
in another order, over a 300 m window where one float32 ulp is 3e-5);
the projection at rtol 1e-5 and an atol of 1e-5 of its coefficients'
scale, the risks at rtol 1e-5, atol 1e-4.  FrenetSolver runs on the JAX solve's draws (the JAX key
chain of ``test_torch_noise.jax_draws`` plus the noisy initial states'
``split(PRNGKey(idx_mpc))[0]``), its workspace and its frame; its controls
(the speed and steering profiles the closed loop applies) must agree within
1e-3, the JAX package's parity bar (tests/test_parity.py:132-145).  The
obstacles block the path ahead, so the least risk is unique in ``saa`` and
``mmd_random`` too (see test_torch_modes.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import frenet as jf
from mpc_mmd_tpu import projection as jproj
from mpc_mmd_tpu import risk as jrisk
from mpc_mmd_tpu.qp import build_workspace as j_build_workspace
from mpc_mmd_tpu.solver_frenet import FrenetSolver as JFrenetSolver
from mpc_mmd_tpu_torch import frenet as tf
from mpc_mmd_tpu_torch import projection as tproj
from mpc_mmd_tpu_torch import risk as trisk
from mpc_mmd_tpu_torch.noise import FixedNoise, init_state_count
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from mpc_mmd_tpu_torch.solver_frenet import FrenetSolver as TFrenetSolver
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _curvy_path(n=600):
    t = np.linspace(0.0, 1.0, n)
    return (np.float32(300.0 * t),
            np.float32(8.0 * np.sin(2.0 * np.pi * t) + 20.0 * t * t))


def _frames():
    x, y = _curvy_path()
    jframe = jf.path_parameters(jnp.asarray(x), jnp.asarray(y))
    return jframe, tf.FrenetFrame(*(_t(f) for f in jframe))


def _close(got, ref, **tol):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **(tol or TOL))


def test_interp_matches_jnp_at_the_ends_on_knots_and_between():
    xp = np.cumsum(np.random.default_rng(0).uniform(0.1, 2.0, 50)).astype(np.float32)
    xp = np.concatenate(([0.0], xp)).astype(np.float32)
    fp = np.sin(xp).astype(np.float32)
    x = np.concatenate((xp, [-5.0, -1e-3, xp[-1] + 1e-3, xp[-1] + 10.0],
                        np.random.default_rng(1).uniform(-1, xp[-1] + 1, 200))
                       ).astype(np.float32)
    got = tf.interp(_t(x), _t(xp), _t(fp)).numpy()
    ref = np.asarray(jnp.interp(x, xp, fp))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[:len(xp) - 1], fp[:-1])   # on the knots
    np.testing.assert_array_equal(got[len(xp):len(xp) + 2], fp[0])
    np.testing.assert_array_equal(got[len(xp) + 2:len(xp) + 4], fp[-1])


def test_path_parameters_match_jax():
    x, y = _curvy_path()
    ref = jf.path_parameters(jnp.asarray(x), jnp.asarray(y))
    got = tf.path_parameters(_t(x), _t(y))
    for name in ("Fx_dot", "Fy_dot", "arc_vec", "arc_length"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), err_msg=name,
                                   **TOL)
    np.testing.assert_allclose(got.kappa.numpy(), np.asarray(ref.kappa),
                               rtol=1e-5, atol=1e-6)


def test_state_conversion_matches_jax():
    jframe, tframe = _frames()
    states = np.array([[150.2, 15.0, 6.0, 0.8, 0.45, 0.02],
                       [20.0, 1.0, 10.0, 0.5, 0.1, 0.0],
                       [299.0, 22.0, 3.0, -0.3, -0.2, 0.1]], np.float32)
    got = tf.global_to_frenet_state(tframe, _t(states))
    for i, st in enumerate(states):
        ref = jf.global_to_frenet_state(jframe, jnp.asarray(st))
        _close([g[i] for g in got], ref)


def test_obstacle_conversion_of_all_rows_equals_the_per_obstacle_loop():
    jframe, tframe = _frames()
    obs = np.array([[120.0, 10.0, 3.0, 0.5, 0.3], [40.0, 2.0, 0.0, 0.0, 0.0],
                    [500.0, 500.0, 0.0, 0.0, 0.0], [250.0, 15.0, -1.0, 2.0, 1.0]],
                   np.float32)
    got = tf.global_to_frenet_obstacle(tframe, *_t(obs).unbind(1))
    for i, row in enumerate(obs):
        ref = jf.global_to_frenet_obstacle(jframe, *[jnp.float32(v) for v in row])
        _close([g[i] for g in got], ref)


def test_points_and_frenet_to_global_match_jax():
    jframe, tframe = _frames()
    rng = np.random.default_rng(0)
    xs = rng.uniform(20, 250, (3, 4, 20)).astype(np.float32)
    ys = (np.interp(xs, np.asarray(jframe.x_path), np.asarray(jframe.y_path))
          + rng.normal(0, 1.5, xs.shape)).astype(np.float32)
    _close(tf.global_to_frenet_points(tframe, _t(xs), _t(ys)),
           jf.global_to_frenet_points(jframe, jnp.asarray(xs), jnp.asarray(ys)))
    s = np.linspace(-5.0, 400.0, 40).astype(np.float32)
    l = (2.0 * np.sin(np.linspace(0, 3, 40))).astype(np.float32)
    _close(tf.frenet_to_global(tframe, _t(s), _t(l)),
           jf.frenet_to_global(jframe, jnp.asarray(s), jnp.asarray(l)))


def test_spline_window_and_smoothing_match_jax():
    from mpc_mmd_tpu.closedloop import make_route
    route = make_route("curved")
    js, ts = jf.fit_path_spline(*route), tf.fit_path_spline(*route)
    ref = jf.waypoint_window(js, 130.0, 8.0, 300.0, 600)
    got = tf.waypoint_window(ts, 130.0, 8.0, 300.0, 600)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    sw_j, sw_t = jf.build_smoother(600), tf.build_smoother(600, device="cpu")
    np.testing.assert_array_equal(sw_t.kkt_inv.numpy(), np.asarray(sw_j.kkt_inv))
    xw = (got[0] - 130.0).astype(np.float32)
    yw = (got[1] - 8.0).astype(np.float32)
    ref = jf.smooth_path(sw_j, jnp.asarray(xw), jnp.asarray(yw), 0.1)
    _close(tf.smooth_path(sw_t, _t(xw), _t(yw), 0.1), ref, rtol=1e-6, atol=1e-4)


def _proj_case(with_obs, frenet, seed):
    cfg = jc.onroad_workload(num_reduced=3, num_obs=2, num_prime=20)
    cfg = cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=24),
        projection=dataclasses.replace(cfg.projection, maxiter=2,
                                       with_obstacle_terms=with_obs,
                                       gamma_obs=0.7))
    jws = j_build_workspace(cfg)
    tws = workspace_from_numpy({n: np.asarray(getattr(jws, n))
                                for n in jws._fields}, "cpu")
    rng = np.random.default_rng(seed)
    nb, nvar, num = 24, cfg.horizon.nvar, cfg.horizon.num
    P = np.asarray(jws.P, np.float64)
    t = np.linspace(0, 15, num)
    cx = np.stack([np.linalg.lstsq(P, (4 + rng.uniform(0, 8)) * t, rcond=None)[0]
                   for _ in range(nb)]).astype(np.float32)
    cy = np.stack([np.linalg.lstsq(P, rng.uniform(-1, 4) + 0 * t, rcond=None)[0]
                   for _ in range(nb)]).astype(np.float32)
    args = [cx, cy,
            np.tile([0.0, 6.0, 0.0], (nb, 1)), np.tile([1.0, 0.2, 0.0, 0.0], (nb, 1)),
            rng.normal(0, 1, (nb, nvar)), rng.normal(0, 1, (nb, nvar)),
            np.abs(rng.normal(0, 0.1, (nb, 2 * (num - 1)))),
            np.stack([30.0 + 2.0 * t, 55.0 + 0 * t]), np.stack([0.5 + 0 * t, 3.0 + 0 * t])]
    args = [np.asarray(a, np.float32) for a in args]
    kw_j, kw_t = {}, {}
    if frenet:
        jframe, tframe = _frames()
        kw_j = dict(arc_vec=jframe.arc_vec, kappa=jframe.kappa)
        kw_t = dict(arc_vec=tframe.arc_vec, kappa=tframe.kappa)
    ref = jproj.project(cfg, jws, *map(jnp.asarray, args), **kw_j)
    got = tproj.project(to_torch_cfg(cfg), tws, *map(_t, args), **kw_t)
    return ref, got


@pytest.mark.parametrize("with_obs,frenet", [(True, False), (True, True),
                                             (False, True)])
def test_projection_with_obstacle_terms_and_frenet_steering_matches_jax(
        with_obs, frenet):
    ref, got = _proj_case(with_obs, frenet, seed=3)
    # each trajectory value is a sum of coefficient-sized terms (up to ~200
    # here), so round-off is held at 1e-5 of the coefficients' scale
    scale = max(1.0, float(np.abs(ref.c_x).max()), float(np.abs(ref.c_y).max()))
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=name)
    assert bool(got.steering.any()) == frenet


def test_lane_des_risks_match_jax():
    cfg = jc.onroad_workload(num_reduced=4)
    cfg = cfg.replace(lane=dataclasses.replace(cfg.lane, gamma_lane_des=30.0))
    tcfg = to_torch_cfg(cfg)
    rng = np.random.default_rng(5)
    # the bar is max(0, |y - y1| |y - y2| - margin): near the lane centres
    # (rows 0-1) it is 0, elsewhere positive
    y = np.concatenate((np.full((2, 4, 20), 0.05), rng.normal(1.7, 1.0, (5, 4, 20)))
                       ).astype(np.float32)
    beta = rng.dirichlet(np.ones(4), 7).astype(np.float32)
    sigma = rng.uniform(0.01, 1.0, 7).astype(np.float32)
    bar = trisk.lane_des_bar(tcfg, _t(y))
    ref_bar = np.stack([np.asarray(jrisk.lane_des_bar(cfg, jnp.asarray(r))) for r in y])
    np.testing.assert_allclose(bar.numpy(), ref_bar, rtol=1e-5, atol=1e-4)
    assert not bar[:2].any() and bool((bar[2:] > 0).all())
    for name, got, ref in (
            ("mmd", trisk.mmd_lane_des(tcfg, _t(beta), _t(sigma), _t(y)),
             jax.vmap(lambda b, s, r: jrisk.mmd_lane_des(cfg, b, s, r))(
                 jnp.asarray(beta), jnp.asarray(sigma), jnp.asarray(y))),
            ("cvar", trisk.cvar_lane_des(tcfg, _t(y)),
             jax.vmap(lambda r: jrisk.cvar_lane_des(cfg, r))(jnp.asarray(y))),
            ("saa", trisk.saa_lane_des(tcfg, _t(y)),
             jax.vmap(lambda r: jrisk.saa_lane_des(cfg, r))(jnp.asarray(y)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# FrenetSolver against the JAX FrenetSolver
# ---------------------------------------------------------------------------

IDX = 3
MEAN0 = np.asarray([10.0] * 4 + [1.75] * 4, np.float32)
COV0 = np.diag([20.0] * 4 + [100.0] * 4).astype(np.float32)


def frenet_cfg(mode, maxiter_cem, weight_lane_des=0.0):
    """The closed-loop tests' small on-road size, with 24 candidates (at
    least the 20 the solve keeps by risk) and 16 inner samples."""
    cfg = jc.onroad_workload(num_reduced=3, num_obs=2, num_prime=20, mode=mode)
    return cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=maxiter_cem),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16, maxiter=3),
        risk=dataclasses.replace(cfg.risk, weight_lane_des=weight_lane_des))


def frenet_draws(cfg, idx_mpc):
    """The JAX Frenet solve's draws: the straight solve's key chain plus the
    noisy initial states' standard normals."""
    d = jax_draws(cfg, idx_mpc)
    key = jax.random.split(jax.random.PRNGKey(idx_mpc))[0]
    d["init_state_z"] = np.asarray(jax.random.normal(
        key, (init_state_count(cfg), 4)))
    return d


_JAX_SOLVERS = {}


def jax_solver(cfg):
    if cfg not in _JAX_SOLVERS:
        _JAX_SOLVERS[cfg] = JFrenetSolver(cfg)
    return _JAX_SOLVERS[cfg]


def _scenario():
    jframe, tframe = _frames()
    t = np.linspace(0.0, 15.0, 100)
    x_obs = np.stack([42.0 + 1.0 * t, 48.0 + 0.8 * t]).astype(np.float32)
    y_obs = np.stack([0.5 + 0 * t, 3.0 + 0 * t]).astype(np.float32)
    x, y = np.asarray(jframe.x_path), np.asarray(jframe.y_path)
    psi0 = float(np.arctan2(np.asarray(jframe.Fy_dot)[60],
                            np.asarray(jframe.Fx_dot)[60]))
    init = np.asarray([x[60], y[60] + 0.5, 5.0, 0.0, psi0, 0.0], np.float32)
    return jframe, tframe, init, x_obs, y_obs


def solve_both(mode, maxiter_cem, weight_lane_des=0.0):
    cfg = frenet_cfg(mode, maxiter_cem, weight_lane_des)
    js = jax_solver(cfg)
    jframe, tframe, init, xo, yo = _scenario()
    ref = js.solve(IDX, jnp.asarray(init), jnp.asarray(MEAN0), jnp.asarray(COV0),
                   jnp.asarray(xo), jnp.asarray(yo), 10.0, jframe)
    ws = workspace_from_numpy({n: np.asarray(getattr(js.ws, n))
                               for n in js.ws._fields}, "cpu")
    ts = TFrenetSolver(to_torch_cfg(cfg), device="cpu", ws=ws,
                       noise=FixedNoise(frenet_draws(cfg, IDX), "cpu"))
    return ts.solve(IDX, init, MEAN0, COV0, xo, yo, 10.0, tframe), ref


@pytest.mark.parametrize("mode,maxiter_cem", [
    ("mmd_opt", 1), ("mmd_opt", 3), ("cvar", 1), ("cvar", 3), ("det", 1),
    ("det", 3), ("saa", 1), ("mmd_random", 1)])
def test_frenet_solver_matches_jax(mode, maxiter_cem):
    got, ref = solve_both(mode, maxiter_cem)
    for name in ("v_best", "steering_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    for name in ("risk_obs", "res", "mean_param", "cov_param"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    assert got.res.shape == (maxiter_cem,)


def test_frenet_solver_with_the_desired_lane_risk_matches_jax():
    """weight_lane_des is 0 in every preset; set, the cvar solve adds the
    weighted desired-lane CVaR to its cost, as the JAX solve does."""
    got, ref = solve_both("cvar", 1, weight_lane_des=0.5)
    for name in ("v_best", "steering_best", "mean_param", "res"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_frenet_solver_refuses_what_is_not_ported():
    tcfg = to_torch_cfg(frenet_cfg("cvar", 1))
    with pytest.raises(NotImplementedError):
        TFrenetSolver(tcfg.replace(rollout_backend="scan"), device="cpu")
    det = TFrenetSolver(tcfg.with_risk_mode("det"), device="cpu")
    assert det.cfg.projection.with_obstacle_terms
