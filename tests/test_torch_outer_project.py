"""Kernel (d)'s wrapper ``ops.outer_project`` against the JAX package's
guess QP, projection and controls, with and without the obstacle terms.

On the CPU the wrapper runs its plain version (``outer_project_plain``:
``qp.compute_guess``, ``projection.project``,
``dynamics.controls_from_trajectory``), the chain the kernel replaces on
the card; the card-only cases in ``tests/test_torch_gpu.py`` hold the
kernel against that chain.  Both packages get the same float32 workspace,
parameters, boundary rows and carried multipliers and slack (those a JAX
projection leaves), made from a numpy seed, at 16 candidates with and
without a path, at one and two AM rounds; row 1's desired speeds lie past
v_max, so that the polar clip saturates; with ``with_obstacle_terms`` (the
``det`` projection, ``mpc_mmd_tpu/projection.py:150-260``) two obstacles
on the candidates' way, against JAX ``project(..., with_obstacle_terms)``
with its obstacle-augmented workspace.  Tolerances: the coefficients
within 2e-3 and the trajectories, residuals, multipliers and slack within
1e-4 of their scale (``tests/test_torch_qp.py``: float32 sums of
coefficient-sized terms in another order); the controls within 1e-3 of
their scale (acc is a forward difference of speeds over dt = 0.15 s).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import dynamics as jdyn
from mpc_mmd_tpu import projection as jproj
from mpc_mmd_tpu import qp as jqp
from mpc_mmd_tpu_torch import ops
from mpc_mmd_tpu_torch.ops.outer_project import outer_project_plain
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)

NB = 16


def _obstacles(num):
    """Two obstacles (2, num) on the candidates' way: one ahead in their
    lane, slower, and one in the other lane."""
    t = np.linspace(0.0, 15.0, num)
    return (np.stack([25.0 + 8.0 * t, 60.0 + 5.0 * t]).astype(np.float32),
            np.stack([1.75 + 0 * t, -1.75 + 0 * t]).astype(np.float32))


def _case(maxiter, path, seed=0, obs=False):
    """(cfg, the JAX workspace, the port's, inputs as numpy, path kwargs);
    with ``obs`` the obstacle terms, and the kwargs carry the obstacles."""
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2, num_prime=15)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=NB),
                      projection=dataclasses.replace(cfg.projection, maxiter=maxiter,
                                                     with_obstacle_terms=obs))
    jws = jqp.build_workspace(cfg)
    tws = workspace_from_numpy({n: np.asarray(getattr(jws, n)) for n in jws._fields},
                               "cpu")
    rng = np.random.default_rng(seed)
    params = np.concatenate((rng.normal(15, 4, (NB, 4)), rng.normal(0, 3, (NB, 4))),
                            axis=1).astype(np.float32)
    params[1, :4] = 100.0
    init = np.asarray([0.0, 1.75, 5.0, 0.3, 0.1, -0.2], np.float32)
    bx, by = (np.asarray(b) for b in jqp.boundary_vectors(cfg, jnp.asarray(init)))
    kw = {}
    if path:
        s = np.linspace(0.0, 300.0, 600).astype(np.float32)
        kw = dict(arc_vec=s, kappa=(0.01 * np.sin(s / 30.0)).astype(np.float32))
    # the multipliers and slack of a JAX projection before: a second outer
    # iteration's carried state
    nvar, num = cfg.horizon.nvar, cfg.horizon.num
    gx, gy = jqp.compute_guess(cfg, jws, jnp.asarray(params), bx, by)
    if obs:
        kw["x_obs"], kw["y_obs"] = _obstacles(num)
    zo = jnp.zeros((2, num))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jkw.setdefault("x_obs", zo)
    jkw.setdefault("y_obs", zo)
    first = jproj.project(cfg, jws, gx, gy, bx, by, jnp.zeros((NB, nvar)),
                          jnp.zeros((NB, nvar)), jnp.zeros((NB, 2 * (num - 1))), **jkw)
    carried = [np.asarray(t) for t in (first.lamda_x, first.lamda_y, first.s_lane)]
    return cfg, jws, tws, [params, bx, by, *carried], kw


def _jax(cfg, jws, inputs, kw):
    """compute_guess -> project -> controls_from_trajectory of the JAX package."""
    params, bx, by, lx, ly, sl = map(jnp.asarray, inputs)
    gx, gy = jqp.compute_guess(cfg, jws, params, bx, by)
    zo = jnp.zeros((2, cfg.horizon.num))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jkw.setdefault("x_obs", zo)
    jkw.setdefault("y_obs", zo)
    pr = jproj.project(cfg, jws, gx, gy, bx, by, lx, ly, sl, **jkw)
    acc, steer = jdyn.controls_from_trajectory(pr.xdot, pr.ydot, pr.xddot, pr.yddot,
                                               cfg.horizon.dt, cfg.vehicle.wheel_base)
    return dict(pr._asdict(), acc=acc, steer=steer), gx


# (path, AM rounds, obstacle terms); the cases without obstacle terms keep
# the ids [path-maxiter] they had before
PROJECT_CASES = [pytest.param(path, maxiter, False, id=f"{path}-{maxiter}")
                 for path in (False, True) for maxiter in (1, 2)] + [
    pytest.param(path, maxiter, True, id=f"obstacles-{'road' if path else 'straight'}-"
                 f"{maxiter}") for path in (False, True) for maxiter in (1, 2)]


@pytest.mark.parametrize("path,maxiter,obs", PROJECT_CASES)
def test_outer_project_matches_jax(path, maxiter, obs):
    cfg, jws, tws, inputs, kw = _case(maxiter, path, obs=obs)
    ref, gx = _jax(cfg, jws, inputs, kw)
    # row 1's guess drives faster than v_max: its velocity radius is clipped
    speed = np.abs(np.asarray(jws.Pdot) @ np.asarray(gx[1]))
    assert speed.max() > cfg.vehicle.v_max
    before = ops.outer_project.launches
    got = ops.outer_project(to_torch_cfg(cfg), tws,
                            *(torch.from_numpy(np.array(a)) for a in inputs),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert ops.outer_project.launches == before     # the CPU runs the plain version
    for name in got._fields:
        r, g = np.asarray(ref[name]), getattr(got, name).numpy()
        assert g.shape == r.shape, name
        scale = max(1.0, float(np.abs(r).max()))
        tol = (2e-3 if name in ("c_x", "c_y") else
               1e-3 * scale if name in ("acc", "steer") else 1e-4 * scale)
        np.testing.assert_allclose(g, r, rtol=0, atol=tol, err_msg=name)
    assert bool(got.steering.any()) == path
    assert bool(got.kappa_interp.any()) == path
    if obs:    # the obstacle terms move the trajectories: the stochastic form differs
        plain = outer_project_plain(
            to_torch_cfg(cfg.replace(projection=dataclasses.replace(
                cfg.projection, with_obstacle_terms=False))),
            workspace_from_numpy({n: np.asarray(getattr(jqp.build_workspace(
                cfg.replace(projection=dataclasses.replace(
                    cfg.projection, with_obstacle_terms=False))), n))
                for n in jws._fields}, "cpu"),
            *(torch.from_numpy(np.array(a)) for a in inputs),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert float((plain.y - got.y).abs().max()) > 1e-2


def test_outer_project_on_the_cpu_is_the_plain_version():
    cfg, _, tws, inputs, kw = _case(1, True, seed=1)
    tcfg = to_torch_cfg(cfg)
    args = [torch.from_numpy(np.array(a)) for a in inputs]
    path = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = ops.outer_project(tcfg, tws, *args, **path)
    ref = outer_project_plain(tcfg, tws, *args, **path)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_outer_project_refuses_what_neither_version_takes():
    cfg, _, tws, inputs, kw = _case(1, True)
    tcfg = to_torch_cfg(cfg)
    args = [torch.from_numpy(np.array(a)) for a in inputs]
    path = {k: torch.from_numpy(v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="params"):
        ops.outer_project(tcfg, tws, args[0][:, :6], *args[1:])
    with pytest.raises(ValueError, match="s_lane"):
        ops.outer_project(tcfg, tws, *args[:5], args[5][:, :-1])
    with pytest.raises(ValueError, match="path"):
        ops.outer_project(tcfg, tws, *args, arc_vec=path["arc_vec"])
    with pytest.raises(ValueError, match="path"):
        ops.outer_project(tcfg, tws, *args, arc_vec=path["arc_vec"],
                          kappa=path["kappa"][:-1])
    # the obstacle terms are taken now (test_outer_project_matches_jax); they
    # still need the obstacles, one block each of num steps
    cfg, _, tws, inputs, kw = _case(1, False, obs=True)
    tcfg = to_torch_cfg(cfg)
    args = [torch.from_numpy(np.array(a)) for a in inputs]
    xo, yo = (torch.from_numpy(kw[k]) for k in ("x_obs", "y_obs"))
    with pytest.raises(ValueError, match="obstacle"):
        ops.outer_project(tcfg, tws, *args)
    with pytest.raises(ValueError, match="obstacle"):
        ops.outer_project(tcfg, tws, *args, x_obs=xo[:, :-1], y_obs=yo[:, :-1])
    with pytest.raises(ValueError, match="obstacle"):
        ops.outer_project(tcfg, tws, *args, x_obs=xo[:1], y_obs=yo[:1])


@pytest.mark.parametrize("shape,rows,forced,runtime,want", [
    ((11, 100, 4), 64, 0, False, (1, True)),      # fastrt: compile-time, a row a CTA
    ((11, 100, 4), 199, 0, False, (1, True)),
    ((11, 100, 4), 200, 0, False, (2, True)),     # from TWO_ROWS_FROM rows, two a CTA
    ((11, 100, 4), 2048, 0, False, (2, True)),    # a chunk of 32 scenarios
    ((11, 100, 4), 2048, 1, False, (1, True)),    # forced rows a CTA
    ((11, 100, 4), 64, 2, True, (2, False)),      # forced run-time shape
    ((11, 60, 4), 64, 0, False, (1, False)),      # another num: the run-time shape
    ((12, 100, 4), 64, 0, False, (1, False)),
    ((11, 100, 5), 400, 0, False, (2, False)),
    ((16, 128, 8), 100, 2, False, (2, False))])
def test_launch_choice_picks_the_instantiation_and_the_rows_a_cta(shape, rows, forced,
                                                                  runtime, want):
    from mpc_mmd_tpu_torch.ops.outer_project import launch_choice
    assert launch_choice(*shape, rows, forced, runtime) == want


def test_every_path_shape_takes_the_compile_time_instantiation():
    """fastrt, the dynamic and static workloads (every reduced-set size the
    record's cells take) and the on-road one share kernel (d)'s
    compile-time shape: nvar 11, num 100, 4 guess segments."""
    from mpc_mmd_tpu_torch import (dynamic_workload, fastrt_workload, onroad_workload,
                                   static_workload)
    from mpc_mmd_tpu_torch.ops.outer_project import COMPILED_SHAPE
    cfgs = [fastrt_workload(), dynamic_workload(noise_level=0.2), onroad_workload()] + [
        static_workload(num_reduced=n) for n in (5, 10, 15)]
    for cfg in cfgs:
        h = cfg.horizon
        assert (h.nvar, h.num, cfg.guess.num_segments) == COMPILED_SHAPE


@pytest.mark.parametrize("forced", [-1, 3, 4])
def test_outer_project_refuses_rows_a_cta_outside_the_limits(forced):
    cfg, _, tws, inputs, kw = _case(1, False)
    args = [torch.from_numpy(np.array(a)) for a in inputs]
    with pytest.raises(ValueError, match="rows_per_cta"):
        ops.outer_project(to_torch_cfg(cfg), tws, *args, rows_per_cta=forced)


@pytest.mark.parametrize("forced,runtime", [(1, False), (2, False), (0, True), (2, True)])
def test_outer_project_on_the_cpu_ignores_the_launch_choices(forced, runtime):
    cfg, _, tws, inputs, kw = _case(2, True, seed=2)
    tcfg = to_torch_cfg(cfg)
    args = [torch.from_numpy(np.array(a)) for a in inputs]
    path = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = ops.outer_project(tcfg, tws, *args, **path, rows_per_cta=forced,
                            runtime_shape=runtime)
    ref = outer_project_plain(tcfg, tws, *args, **path)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_inner_split_worker_compiles_and_finds_the_outer_kernels():
    """The stage split's worker (``utils/inner_split.py``) is valid Python,
    and the stages it wraps include kernels (d) and (e) where the solver
    calls them."""
    import importlib
    from mpc_mmd_tpu_torch.utils import inner_split
    compile(inner_split.WORKER, "inner_split.WORKER", "exec")
    for mod, name in (("solver", "outer_project"), ("solver", "outer_tail"),
                      ("projection", "project"), ("sampling", "cem_update")):
        assert f'("{mod}", "{name}")' in inner_split.WORKER
        assert callable(getattr(importlib.import_module(f"mpc_mmd_tpu_torch.{mod}"), name))
