"""Kernel (e)'s wrapper ``ops.outer_tail`` against the JAX package's outer
CEM tail in each risk mode, ``risk.cvar_reduce`` against the JAX one, and
the routing of both solvers' outer iteration to kernels (d) and (e).

On the CPU the wrapper runs its plain version (``outer_tail_plain``: the
mode's risk, then ``sampling.cem_tail``), the chain the kernel replaces on
the card; the card-only cases in ``tests/test_torch_gpu.py`` hold the
kernel against that chain.  The JAX side is the body of its outer
iteration (``mpc_mmd_tpu/solver.py:238-301``, ``solver_frenet.py:199-257``)
written out: the mode's obstacle risk of every candidate (``mmd_obs``,
``cvar_obs``, ``saa_obs``, or zero in ``det``), a stable argsort, the
mode's lane risk (``mmd_lane``, ``cvar_lane``, ``saa_lane``; zero for
``mmd_random`` on the straight road and in ``det``; on the road the
weighted desired-lane risk), ``scalar_cost`` or ``_frenet_scalar_cost``,
a stable argsort, ``cem_update`` with its key, whose normals the port gets
as ``z`` (``test_torch_noise.jax_draws``).  Inputs from a numpy seed at 16
candidates, R = 4 (``mmd_random`` with the uniform weights 1/R and
bandwidth 0.01 that both solvers give it): the candidates in a residual
order that is a permutation of the projection rows; the best elite copied
to another position (a tie in risk and in cost, which both packages keep
in index order); and in ``mmd_opt`` a case whose covariance is not
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
from mpc_mmd_tpu_torch import risk as trisk
from mpc_mmd_tpu_torch import solver as tsolver
from mpc_mmd_tpu_torch.ops.outer_project import OuterProjection
from mpc_mmd_tpu_torch.ops.outer_tail import outer_tail_plain
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)

NB, R, T, IDX, IT = 16, 4, 15, 4, 1


def _cfg(frenet, mode="mmd_opt"):
    if frenet:
        cfg = jc.onroad_workload(num_reduced=R, num_obs=2, num_prime=T, mode=mode)
        cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, weight_lane_des=0.5))
    else:
        cfg = jc.fastrt_workload(num_reduced=R, num_obs=2, num_prime=T, mode=mode)
    return cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=NB, ellite_num=4,
                                               ellite_num_cost=10))


def _inputs(cfg, frenet, nonpd, seed=0, copy=None):
    """numpy inputs: the projection's rows, the residual order, the
    parameters by row, the reduced sets in residual order (in mmd_random
    the uniform weights and bandwidth), the obstacles, the moments; with
    ``copy`` (src, dst) candidate dst (in residual order) a copy of
    candidate src."""
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
    if cfg.risk.mode == "mmd_random":
        beta = np.full((NB, R), 1.0 / R, np.float32)
        sigma = np.full(NB, 0.01, np.float32)
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
    """The JAX package's outer-iteration tail in the mode of ``cfg``,
    written out."""
    c, mode = cfg.cem, cfg.risk.mode
    mmd = mode in ("mmd_opt", "mmd_random")
    w_lane, w_obs = cfg.risk.weights()
    g = {k: jnp.asarray(v)[order] for k, v in rows.items() if np.ndim(v) and k != "res_norm"}
    res_p = jnp.asarray(rows["res_norm"])[order]
    params_p = jnp.asarray(params)[order]
    x_obs_T, y_obs_T = jnp.asarray(x_obs)[:, :T], jnp.asarray(y_obs)[:, :T]
    rolls = (jnp.asarray(x_roll), jnp.asarray(y_roll))
    if mode == "det":
        risk = jnp.zeros(NB)
    elif mmd:
        risk = jax.vmap(lambda b, s, xr, yr: jrisk.mmd_obs(cfg, b, s, xr, yr, x_obs_T,
                                                           y_obs_T))(
            jnp.asarray(beta), jnp.asarray(sigma), *rolls)
    else:
        fn = jrisk.cvar_obs if mode == "cvar" else jrisk.saa_obs
        risk = jax.vmap(lambda xr, yr: fn(cfg, xr, yr, x_obs_T, y_obs_T))(*rolls)
    order2 = jnp.argsort(risk)[:c.ellite_num_cost]
    e = lambda a: jnp.asarray(a)[order2]
    n_cost = c.ellite_num_cost
    if mode == "det" or (mode == "mmd_random" and not frenet):
        lane = jnp.zeros(n_cost)
    elif mmd:
        lane = jax.vmap(lambda b, s, yr: jrisk.mmd_lane(cfg, b, s, yr))(
            e(beta), e(sigma), e(y_roll))
    else:
        fn = jrisk.cvar_lane if mode == "cvar" else jrisk.saa_lane
        lane = jax.vmap(lambda yr: fn(cfg, yr))(e(y_roll))
    if frenet:
        if mode == "det":
            des = jnp.zeros(n_cost)
        elif mmd:
            des = jax.vmap(lambda b, s, yr: jrisk.mmd_lane_des(cfg, b, s, yr))(
                e(beta), e(sigma), e(y_roll))
        else:
            fn = jrisk.cvar_lane_des if mode == "cvar" else jrisk.saa_lane_des
            des = jax.vmap(lambda yr: fn(cfg, yr))(e(y_roll))
        des = cfg.risk.weight_lane_des * des
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
    # what the mode reads, None otherwise (the solvers' convention)
    mmd, rolls = cfg.risk.mode in ("mmd_opt", "mmd_random"), cfg.risk.mode != "det"
    read = lambda a, reads: t(a)[None] if reads else None
    out = (call or ops.outer_tail)(
        tcfg, frenet, pj, t(order)[None], t(params)[None], read(beta, mmd),
        read(sigma, mmd), read(x_roll, rolls), read(y_roll, rolls), t(x_obs)[None],
        t(y_obs)[None], z, t(mean)[None], t(cov)[None], torch.tensor(v_des), res, res_2,
        IT)
    return out, res[0, IT], res_2[0, IT]


# (mode, on the road, covariance not positive definite); the mmd_opt cases
# keep the ids [nonpd-road] they had before the other modes joined
MODE_CASES = [pytest.param("mmd_opt", False, False, id="False-False"),
              pytest.param("mmd_opt", True, False, id="False-True"),
              pytest.param("mmd_opt", False, True, id="True-False"),
              pytest.param("mmd_opt", True, True, id="True-True")] + [
    pytest.param(mode, frenet, False, id=f"{mode}-{'road' if frenet else 'straight'}")
    for mode in ("mmd_random", "cvar", "saa") for frenet in (False, True)] + [
    pytest.param("det", True, False, id="det-road")]


@pytest.mark.parametrize("mode,frenet,nonpd", MODE_CASES)
def test_outer_tail_matches_jax(mode, frenet, nonpd):
    cfg = _cfg(frenet, mode)
    # the best elite of a first pass copied to another candidate
    first = _jax(cfg, frenet, *_inputs(cfg, frenet, nonpd), 15.0)
    src = int(first["kept"][int(first["elites"][0])])
    if mode == "det":        # every risk ties: the kept are the first n_cost
        dst = int(first["kept"][(int(first["elites"][0]) + 3) % cfg.cem.ellite_num_cost])
    else:
        dst = (src + 5) % NB
    lo, hi = sorted((src, dst))
    inputs = _inputs(cfg, frenet, nonpd, copy=(src, dst))
    ref = _jax(cfg, frenet, *inputs, 15.0)
    before = ops.outer_tail.launches
    got, res, res_2 = _port(cfg, frenet, *inputs, 15.0)
    assert ops.outer_tail.launches == before       # the CPU runs the plain version
    # the copy ties with its original in risk and in cost: both kept, both
    # elites, in index order (where the copy's tied risk keeps it, as in
    # every mmd_opt case and in det)
    kept = np.asarray(ref["kept"]).tolist()
    if mode in ("mmd_opt", "det"):
        assert lo in kept and hi in kept
    if lo in kept and hi in kept:
        assert kept.index(lo) < kept.index(hi)
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
    """Every risk mode is taken now (``test_outer_tail_matches_jax``);
    still refused: a mode the solvers do not have, inputs of the wrong
    shape, and no rollouts in a mode that reads them."""
    cfg = _cfg(False)
    inputs = list(_inputs(cfg, False, False))
    bad = to_torch_cfg(cfg)
    bad = bad.replace(risk=dataclasses.replace(bad.risk, mode="mmd_opt"))
    object.__setattr__(bad.risk, "mode", "quantile")
    with pytest.raises(ValueError, match="mode"):
        _port(cfg, False, *inputs, 15.0,
              call=lambda c, *a: ops.outer_tail(bad, *a))
    with pytest.raises(ValueError, match="x_roll"):
        _port(cfg.with_risk_mode("cvar"), False, *inputs, 15.0,
              call=lambda c, f, pj, o, p, b, s, xr, yr, *a: ops.outer_tail(
                  c, f, pj, o, p, b, s, None, None, *a))
    inputs[3] = inputs[3][:, :3]          # beta of R - 1
    with pytest.raises(ValueError, match="beta"):
        _port(cfg, False, *inputs, 15.0)


@pytest.mark.parametrize("mode", ["mmd_random", "cvar", "saa", "det"])
def test_outer_tail_refuses_inputs_the_mode_does_not_read(mode):
    """One convention: the solvers pass beta and sigma in the MMD modes
    alone and the rollouts in every mode but det, None otherwise; the
    wrapper refuses weights the mode does not read (and det's rollouts)
    and no weights where it reads them, rather than drop or fill them."""
    cfg = _cfg(True, mode)
    inputs = _inputs(cfg, True, False, seed=4)
    _port(cfg, True, *inputs, 12.0)                   # the convention runs
    tensor = lambda a: torch.from_numpy(np.array(a))[None]
    mmd = mode == "mmd_random"
    flip = lambda c, f, pj, o, p, b, s, *a: ops.outer_tail(
        c, f, pj, o, p, *((None, None) if mmd else (tensor(inputs[3]), tensor(inputs[4]))),
        *a)
    with pytest.raises(ValueError, match=f"beta must be {'given' if mmd else 'None'} "
                                         f"in {mode}"):
        _port(cfg, True, *inputs, 12.0, call=flip)
    if mode == "det":
        rolls = lambda c, f, pj, o, p, b, s, xr, yr, *a: ops.outer_tail(
            c, f, pj, o, p, b, s, tensor(inputs[5]), tensor(inputs[6]), *a)
        with pytest.raises(ValueError, match="x_roll must be None in det"):
            _port(cfg, True, *inputs, 12.0, call=rolls)


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


def _obstacle_terms(cfg):
    return cfg.replace(projection=dataclasses.replace(cfg.projection,
                                                      with_obstacle_terms=True))


@pytest.mark.parametrize("make,routes", [
    (lambda: Solver(to_torch_cfg(_cfg(False)), device="cpu"), (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("cvar")), device="cpu"),
     (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("saa")), device="cpu"),
     (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("mmd_random")),
                    device="cpu"), (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).replace(solve_strategy="exact")),
                    device="cpu"), (False, False)),
    (lambda: Solver(to_torch_cfg(_cfg(False)), device="cpu", candidate_mesh=_Mesh()),
     (True, False)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True)), device="cpu"), (True, True)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True).with_risk_mode("det")), device="cpu"),
     (True, True)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True).replace(solve_strategy="exact")),
                          device="cpu"), (False, False)),
    (lambda: Solver(to_torch_cfg(_obstacle_terms(_cfg(False).with_risk_mode("cvar"))),
                    device="cpu"), (True, True)),
    (lambda: Solver(to_torch_cfg(_cfg(False).with_risk_mode("saa")), device="cpu",
                    candidate_mesh=_Mesh()), (True, False)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True, "det").replace(solve_strategy="exact")),
                          device="cpu"), (False, False)),
    (lambda: FrenetSolver(to_torch_cfg(_cfg(True, "cvar")), device="cpu"), (True, True))])
def test_routes_take_kernels_d_and_e_where_they_apply(make, routes):
    """Which configurations reach kernel (d) (every mode under
    "prefactored", the obstacle-active projection of ``det`` and of
    ``with_obstacle_terms`` too) and kernel (e) (every mode of both solvers
    under "prefactored" without a candidate mesh of several ranks), and
    which keep their chains ("exact" both, a mesh the tail)."""
    assert make()._routes() == routes


def test_a_solve_calls_the_wrappers_once_an_outer_iteration(monkeypatch):
    """A CPU solve in each mode goes through both wrappers (their plain
    versions here) once an outer iteration, and so does a det step of the
    closed loop."""
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
    for mode, tail in (("mmd_opt", True), ("cvar", True), ("saa", True),
                       ("mmd_random", True)):
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
    from mpc_mmd_tpu_torch.closedloop import run_episode
    cfg = _cfg(True, "det")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))
    for name in calls:
        calls[name] = 0
    r = run_episode(to_torch_cfg(cfg), max_steps=1, device="cpu")
    assert len(r.solve_times) == 1
    assert calls == {"outer_project": 2, "outer_tail": 2}


@pytest.mark.parametrize("R", [4, 10])
def test_cvar_reduce_matches_jax(R):
    """``risk.cvar_reduce`` (kernel (e)'s CVaR form holds its bits on the
    card) against the JAX one at alpha 0.98: random rows, a row whose
    quantile position holds a tie, an all-zero row (0), a row with a NaN
    (0: its quantile is NaN, so no sample passes the >= mask) and a row of
    one value repeated (the desired-lane barrier's form).  Within rtol 1e-6:
    the two packages interpolate the quantile with other roundings."""
    rng = np.random.default_rng(R)
    rows = rng.uniform(0.0, 2.0, (8, R)).astype(np.float32)
    rows[1, -2:] = rows[1, :2] = rows[1].max()    # ties at the top positions
    rows[2] = 0.0
    rows[3, 1] = np.nan
    rows[4] = 0.75
    rows[5, : R // 2] = 0.0
    ref = np.asarray(jrisk.cvar_reduce(jnp.asarray(rows), 0.98))
    got = trisk.cvar_reduce(torch.from_numpy(rows), 0.98).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert got[2] == 0.0 and got[3] == 0.0 and got[4] == np.float32(0.75)
