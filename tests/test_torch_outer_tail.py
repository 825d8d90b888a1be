"""Kernel (e)'s wrapper ``ops.outer_tail`` against the JAX package's outer
CEM tail in ``mmd_opt``, and the routing of both solvers' outer iteration
to kernels (d) and (e).

On the CPU the wrapper runs its plain version (``outer_tail_plain``:
``risk.mmd_obs``, then ``sampling.cem_tail``), the chain the kernel
replaces on the card; the card-only cases in ``tests/test_torch_gpu.py``
hold the kernel against that chain.  The JAX side is the body of its outer
iteration (``mpc_mmd_tpu/solver.py:235-300``, ``solver_frenet.py:201-257``)
written out: ``mmd_obs`` of every candidate, a stable argsort, ``mmd_lane``
(and on the road the weighted ``mmd_lane_des``), ``scalar_cost`` or
``_frenet_scalar_cost``, a stable argsort, ``cem_update`` with its key,
whose normals the port gets as ``z`` (``test_torch_noise.jax_draws``).
Inputs from a numpy seed at 16 candidates, R = 4: the candidates in a
residual order that is a permutation of the projection rows; the best
elite copied to another position (a tie in risk and in cost, which both
packages keep in index order); and a case whose covariance is not
positive definite (its resample NaN in both).  Indices (the kept, the
elites, the pick) equal exactly; the moments and parameters within rtol
1e-5 + atol 1e-4 (``test_torch_noise``'s bound for ``cem_update``); the
risks and costs within rtol 1e-5 + atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import risk as jrisk
from mpc_mmd_tpu import sampling as jsampling
from mpc_mmd_tpu.solver_frenet import _frenet_scalar_cost
from mpc_mmd_tpu_torch import FrenetSolver, Solver, ops
from mpc_mmd_tpu_torch import solver as tsolver
from mpc_mmd_tpu_torch.ops.outer_project import OuterProjection
from mpc_mmd_tpu_torch.ops.outer_tail import outer_tail_plain
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)

NB, R, T, IDX, IT = 16, 4, 15, 4, 1


def _cfg(frenet):
    if frenet:
        cfg = jc.onroad_workload(num_reduced=R, num_obs=2, num_prime=T)
        cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, weight_lane_des=0.5))
    else:
        cfg = jc.fastrt_workload(num_reduced=R, num_obs=2, num_prime=T)
    return cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=NB, ellite_num=4,
                                               ellite_num_cost=10))


def _inputs(cfg, frenet, nonpd, seed=0, copy=None):
    """numpy inputs: the projection's rows, the residual order, the
    parameters by row, the reduced sets in residual order, the obstacles,
    the moments; with ``copy`` (src, dst) candidate dst (in residual order)
    a copy of candidate src."""
    rng = np.random.default_rng(seed)
    num = cfg.horizon.num
    t = np.linspace(0.0, 15.0, num)
    speed = rng.uniform(8, 16, (NB, 1))
    rows = dict(y=rng.normal(0, 1.0, (NB, 1)) + 0.05 * np.sin(t + rng.uniform(0, 6, (NB, 1))),
                xdot=speed + 0.2 * np.sin(t / 3), ydot=0.3 * np.cos(t / 2 + rng.normal(size=(NB, 1))),
                xddot=0.1 * rng.normal(size=(NB, num)), yddot=0.1 * rng.normal(size=(NB, num)),
                res_norm=rng.uniform(0, 2, NB), steer=0.05 * rng.normal(size=(NB, num)),
                steering=0.05 * rng.normal(size=(NB, num)),
                kappa_interp=0.01 * rng.normal(size=(NB, num)))
    rows = {k: np.asarray(v, np.float32) for k, v in rows.items()}
    order = rng.permutation(NB)
    params = np.concatenate((rng.normal(15, 4, (NB, 4)), rng.normal(0, 3, (NB, 4))),
                            axis=1).astype(np.float32)
    x_c = speed[order] * t[None, :T]
    x_roll = (x_c[:, None, :] + rng.normal(0, 1.5, (NB, R, T))).astype(np.float32)
    y_roll = rng.normal(0, 1.5, (NB, R, T)).astype(np.float32)
    beta = rng.uniform(0.1, 1.0, (NB, R))
    beta = (beta / beta.sum(axis=1, keepdims=True)).astype(np.float32)
    sigma = rng.uniform(0.5, 1.5, NB).astype(np.float32)
    # obstacles among every candidate's rollouts: distinct violations, so
    # that no two risks tie within round-off unless a candidate is copied
    x_obs = np.stack([3.0 + 10.0 * t, 8.0 + 12.0 * t]).astype(np.float32)
    y_obs = np.stack([0.5 + 0 * t, -1.0 + 0 * t]).astype(np.float32)
    if copy is not None:
        src, dst = copy
        for k in rows:
            rows[k][order[dst]] = rows[k][order[src]]
        params[order[dst]] = params[order[src]]
        for a in (x_roll, y_roll, beta, sigma):
            a[dst] = a[src]
    mean = np.asarray([15.0] * 4 + [0.0] * 4, np.float32)
    A = rng.normal(0, 1, (8, 8))
    cov = (A @ A.T + np.eye(8)).astype(np.float32)
    if nonpd:
        cov = -cov
    return rows, order, params, beta, sigma, x_roll, y_roll, x_obs, y_obs, mean, cov


def _jax(cfg, frenet, rows, order, params, beta, sigma, x_roll, y_roll, x_obs, y_obs,
         mean, cov, v_des):
    """The JAX package's outer-iteration tail, written out."""
    c = cfg.cem
    w_lane, w_obs = cfg.risk.weights()
    g = {k: jnp.asarray(v)[order] for k, v in rows.items() if np.ndim(v) and k != "res_norm"}
    res_p = jnp.asarray(rows["res_norm"])[order]
    params_p = jnp.asarray(params)[order]
    x_obs_T, y_obs_T = jnp.asarray(x_obs)[:, :T], jnp.asarray(y_obs)[:, :T]
    risk = jax.vmap(lambda b, s, xr, yr: jrisk.mmd_obs(cfg, b, s, xr, yr, x_obs_T,
                                                       y_obs_T))(
        jnp.asarray(beta), jnp.asarray(sigma), jnp.asarray(x_roll), jnp.asarray(y_roll))
    order2 = jnp.argsort(risk)[:c.ellite_num_cost]
    e = lambda a: jnp.asarray(a)[order2]
    lane = jax.vmap(lambda b, s, yr: jrisk.mmd_lane(cfg, b, s, yr))(
        e(beta), e(sigma), e(y_roll))
    if frenet:
        des = cfg.risk.weight_lane_des * jax.vmap(
            lambda b, s, yr: jrisk.mmd_lane_des(cfg, b, s, yr))(e(beta), e(sigma), e(y_roll))
        cost = _frenet_scalar_cost(cfg, des, w_obs * risk[order2], w_lane * lane,
                                   g["y"][order2], res_p[order2], g["xdot"][order2],
                                   g["ydot"][order2], g["xddot"][order2],
                                   g["yddot"][order2], g["steering"][order2],
                                   g["kappa_interp"][order2], v_des)
    else:
        cost = jsampling.scalar_cost(cfg, w_obs * risk[order2], w_lane * lane,
                                     g["y"][order2], res_p[order2], g["xdot"][order2],
                                     g["ydot"][order2], g["xddot"][order2],
                                     g["yddot"][order2], g["steer"][order2], v_des)
    elite = jnp.argsort(cost)[:c.ellite_num]
    key = jax.random.split(jax.random.split(
        jax.random.PRNGKey(3 * IDX + 5 * IT + 7))[0])[0]
    mean, cov, nxt = jsampling.cem_update(cfg, key, params_p[order2][elite], cost[elite],
                                          jnp.asarray(mean), jnp.asarray(cov))
    idx_min = jnp.argmin(cost[elite])
    return dict(kept=order2, elites=elite, best=order2[idx_min], mean=mean, cov=cov,
                params=nxt, res=jnp.min(cost[elite]), res_2=res_p[order2][idx_min],
                risk_obs=risk[order2][idx_min], risk_lane=lane[idx_min])


def _port(cfg, frenet, rows, order, params, beta, sigma, x_roll, y_roll, x_obs, y_obs,
          mean, cov, v_des, call=None):
    tcfg = to_torch_cfg(cfg)
    t = lambda a: torch.from_numpy(np.array(a))
    num = cfg.horizon.num
    z = t(jax_draws(cfg, IDX)["cem_z"][IT])[None]
    pj = OuterProjection(
        c_x=torch.zeros(NB, 11), c_y=torch.zeros(NB, 11), x=torch.zeros(NB, num),
        **{k: t(v) for k, v in rows.items()},
        lamda_x=torch.zeros(NB, 11), lamda_y=torch.zeros(NB, 11),
        s_lane=torch.zeros(NB, 2 * (num - 1)), acc=torch.zeros(NB, num))
    res = torch.zeros(1, cfg.cem.maxiter_cem)
    res_2 = torch.zeros(1, cfg.cem.maxiter_cem)
    out = (call or ops.outer_tail)(
        tcfg, frenet, pj, t(order)[None], t(params)[None], t(beta)[None], t(sigma)[None],
        t(x_roll)[None], t(y_roll)[None], t(x_obs)[None], t(y_obs)[None], z,
        t(mean)[None], t(cov)[None], torch.tensor(v_des), res, res_2, IT)
    return out, res[0, IT], res_2[0, IT]


@pytest.mark.parametrize("frenet", [False, True])
@pytest.mark.parametrize("nonpd", [False, True])
def test_outer_tail_matches_jax(frenet, nonpd):
    cfg = _cfg(frenet)
    # the best elite of a first pass copied to another candidate
    first = _jax(cfg, frenet, *_inputs(cfg, frenet, nonpd), 15.0)
    src = int(first["kept"][int(first["elites"][0])])
    lo, hi = sorted((src, (src + 5) % NB))
    inputs = _inputs(cfg, frenet, nonpd, copy=(src, (src + 5) % NB))
    ref = _jax(cfg, frenet, *inputs, 15.0)
    before = ops.outer_tail.launches
    got, res, res_2 = _port(cfg, frenet, *inputs, 15.0)
    assert ops.outer_tail.launches == before       # the CPU runs the plain version
    # the copy ties with its original in risk and in cost: both kept, both
    # elites, in index order
    kept = np.asarray(ref["kept"]).tolist()
    assert lo in kept and hi in kept and kept.index(lo) < kept.index(hi)
    elites = [kept[i] for i in np.asarray(ref["elites"])]
    assert lo in elites and hi in elites and elites.index(lo) < elites.index(hi)
    np.testing.assert_array_equal(got.kept[0].numpy(), kept)
    np.testing.assert_array_equal(got.elites[0].numpy(), np.asarray(ref["elites"]))
    assert int(got.best[0]) == int(ref["best"])
    for name, g in (("mean", got.mean[0]), ("cov", got.cov[0]), ("params", got.params[0]),
                    ("res", res), ("res_2", res_2), ("risk_obs", got.risk_obs[0]),
                    ("risk_lane", got.risk_lane[0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]), rtol=1e-5, atol=1e-4,
                                   err_msg=name)
    fresh = got.params[0, cfg.cem.ellite_num:]
    assert bool(fresh.isnan().all()) == nonpd


def test_outer_tail_on_the_cpu_is_the_plain_version():
    cfg = _cfg(True)
    inputs = _inputs(cfg, True, False, seed=2)
    got = _port(cfg, True, *inputs, 12.0)
    ref = _port(cfg, True, *inputs, 12.0, call=outer_tail_plain)
    assert all(torch.equal(g, r) for g, r in zip(got[0], ref[0]))
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])


def test_outer_tail_refuses_what_neither_version_takes():
    cfg = _cfg(False)
    inputs = list(_inputs(cfg, False, False))
    with pytest.raises(ValueError, match="mmd_opt"):
        _port(cfg.with_risk_mode("cvar"), False, *inputs, 15.0)
    inputs[3] = inputs[3][:, :3]          # beta of R - 1
    with pytest.raises(ValueError, match="beta"):
        _port(cfg, False, *inputs, 15.0)


@pytest.mark.parametrize("cluster", [3, 16, -1])
def test_outer_tail_refuses_a_cluster_outside_its_sizes(cluster):
    """The forced cluster size is 0 (the kernel picks), 1, 2, 4 or 8 CTAs a
    scenario; the wrapper refuses any other before it looks at the device."""
    cfg = _cfg(False)
    inputs = _inputs(cfg, False, False)
    with pytest.raises(ValueError, match="cluster"):
        _port(cfg, False, *inputs, 15.0,
              call=lambda *a: ops.outer_tail(*a, cluster=cluster))


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8])
def test_outer_tail_on_the_cpu_ignores_the_launch_options(cluster):
    """A forced cluster size and a kept_cta buffer (the card's per-CTA
    ranks) leave the CPU's plain version as it is: the buffer untouched."""
    cfg = _cfg(True)
    inputs = _inputs(cfg, True, False, seed=3)
    per_cta = torch.full((8, cfg.cem.ellite_num_cost), -1, dtype=torch.int64)
    got = _port(cfg, True, *inputs, 12.0, call=lambda *a: ops.outer_tail(
        *a, cluster=cluster, kept_cta=per_cta))
    ref = _port(cfg, True, *inputs, 12.0, call=outer_tail_plain)
    assert all(torch.equal(g, r) for g, r in zip(got[0], ref[0]))
    assert bool((per_cta == -1).all())


class _Mesh:
    world, rank = 2, 0


@pytest.mark.parametrize("make,routes", [
    (lambda: Solver(to_torch_cfg(_cfg(False)), device="cpu"), (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("cvar")), device="cpu"),
     (True, False)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("saa")), device="cpu"),
     (True, False)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("mmd_random")),
                    device="cpu"), (True, False)),
    (lambda: Solver(to_torch_cfg(_cfg(False).replace(solve_strategy="exact")),
                    device="cpu"), (False, False)),
    (lambda: Solver(to_torch_cfg(_cfg(False)), device="cpu", candidate_mesh=_Mesh()),
     (True, False)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True)), device="cpu"), (True, True)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True).with_risk_mode("det")), device="cpu"),
     (False, False)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True).replace(solve_strategy="exact")),
                          device="cpu"), (False, False))])
def test_routes_take_kernels_d_and_e_where_they_apply(make, routes):
    """Which configurations reach kernel (d) (every risk-aware mode under
    "prefactored") and kernel (e) (``mmd_opt`` of both solvers without a
    candidate mesh of several ranks), and which keep their chains (``det``'s
    obstacle terms, "exact", the tails of cvar, saa and mmd_random, a mesh)."""
    assert make()._routes() == routes


def test_a_solve_calls_the_wrappers_once_an_outer_iteration(monkeypatch):
    """A CPU solve in mmd_opt goes through both wrappers (their plain
    versions here) once an outer iteration, and in cvar through kernel (d)'s
    only."""
    from mpc_mmd_tpu_torch.noise import FixedNoise
    calls = {"outer_project": 0, "outer_tail": 0}

    def counting(name):
        fn = getattr(tsolver, name)

        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    for name in calls:
        monkeypatch.setattr(tsolver, name, counting(name))
    for mode, tail in (("mmd_opt", True), ("cvar", False)):
        cfg = _cfg(False).with_risk_mode(mode)
        cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2),
                          beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12,
                                                       maxiter=2))
        for name in calls:
            calls[name] = 0
        s = Solver(to_torch_cfg(cfg), device="cpu",
                   noise=FixedNoise(jax_draws(cfg, 0), "cpu"))
        t = np.linspace(0, 15, cfg.horizon.num)
        xo = np.stack([20 + t, 40 + t]).astype(np.float32)
        yo = np.stack([0 * t, 1.5 + 0 * t]).astype(np.float32)
        r = s.solve(0, [0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
                    np.diag([20.0] * 4 + [100.0] * 4), xo, yo, 15.0)
        assert bool(torch.isfinite(r.cx).all())
        assert calls == {"outer_project": 2, "outer_tail": 2 if tail else 0}
