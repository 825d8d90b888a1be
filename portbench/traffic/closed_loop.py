"""Traffic driver ``closed_loop``: the vehicle stack's control period,
episodes of the frozen world's plant run back to back until the window
ends.

A period is the program's ``closedloop.local_problem`` (waypoint window,
perception, kernel (h)'s local path, kernel (g)'s obstacle trajectories)
and ``FrenetSolver.solve``, warm-started from the last step's mean, up to
``torch.cuda.synchronize()``.  Between periods (inside the window, outside
the period): the result's copy to the host, the actuation with its Gaussian
noise and the plant's step.  An episode ends at the goal, at a collision
or after ``max_steps``; the next one starts at once with obstacles placed
anew.

Parameters (``workloads/<cell>.json``): ``route``, ``v_des``, ``goal_arc``,
``max_steps``; ``obstacles``, one [[arc lo, arc hi], [offset lo, offset
hi]] a static obstacle, each episode's positions drawn from the seed
uniformly in them; ``warm`` steps in set-up (the first captures the solve's
graph) on a throwaway episode; ``compare`` steps of the window, drawn from
the seed, whose local problem and solve the reference works out again from
the step's raw inputs (the plant's and obstacles' states, the warm-start
mean, the step's ``idx_mpc``); ``traced_periods``; ``limits``.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from portbench import world
from portbench.harness.compare import collect, gap, maybe_tf32, numbers, raw, reduce
from portbench.reference import closedloop as ref_closedloop
from portbench.reference.frenet import build_smoother as ref_smoother
from portbench.reference.solver_frenet import FrenetSolver as RefFrenetSolver


def _plant(s):
    cfg = s.ctx.cfg
    place = [(s.place.uniform(*arc), s.place.uniform(*off)) for arc, off in s.obstacles]
    return world.SyntheticPlant(s.spline, place, cfg.horizon.dt, cfg.vehicle.wheel_base,
                                cfg.obstacles.a_obs, cfg.obstacles.b_obs)


def new_episode(s) -> None:
    s.plant = _plant(s)
    s.step = 0
    s.mean = s.mean0
    s.snap = s.plant.snapshot()
    s.episodes += 1


def build(ctx):
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.frenet import build_smoother
    p, cfg, dev = ctx.params, ctx.cfg, ctx.device
    v_des = float(p["v_des"])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    spline = world.route_spline(p["route"])
    s = SimpleNamespace(
        ctx=ctx, spline=spline, v_des=v_des, frenet=True, host={"local_problem_s": []},
        obstacles=[tuple(map(tuple, o)) for o in p["obstacles"]],
        place=np.random.RandomState(ctx.rng(0).integers(0, 2 ** 31 - 1)),
        noise=np.random.RandomState(ctx.rng(1).integers(0, 2 ** 31 - 1)),
        idx=int(ctx.rng(3).integers(0, 2 ** 30)),
        solver=FrenetSolver(cfg, device=dev),
        smoother=build_smoother(cfg.frenet.num_path, device=dev),
        mean0=f32([v_des] * 4 + [0.0] * 4), cov=f32(np.diag([20.0] * 4 + [100.0] * 4)),
        tot_time=f32(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num)),
        goal=np.array([float(spline.cs_x(p["goal_arc"])), float(spline.cs_y(p["goal_arc"]))]),
        kept=[], episodes=0, probe=ctx.trace, last=None)
    new_episode(s)
    for _ in range(int(p["warm"])):
        period(s, traced=True)
        between(s)
    s.episodes = 0
    new_episode(s)
    return s


def period(s, traced: bool = False) -> int:
    from mpc_mmd_tpu_torch.closedloop import local_problem
    cfg = s.ctx.cfg
    t0 = time.perf_counter()
    with record_function("portbench.local_problem"):
        frame, x_obs, y_obs, init = local_problem(cfg, s.plant, s.smoother, s.tot_time)
        if s.probe:
            s.ctx.sync()
            s.host["local_problem_s"].append(time.perf_counter() - t0)
    with record_function("portbench.solve"):
        r = s.solver.solve(s.idx, init, s.mean, s.cov, x_obs, y_obs, s.v_des, frame)
        s.ctx.sync()
    if not traced:
        s.kept.append(dict(snap=s.snap, mean=s.mean, idx=s.idx, out=r,
                           local=dict(frame._asdict(), x_obs=x_obs, y_obs=y_obs, init=init)))
    s.last = r
    s.mean = r.mean_param
    s.idx += 1
    return 1


def between(s) -> None:
    """The result to the host, the actuation and the plant's step; the next
    episode where this one ended."""
    cfg, plant, r = s.ctx.cfg, s.plant, s.last
    nmu = cfg.frenet.num_mean_update
    with record_function("portbench.result_copy"):
        v_ctrl = float(torch.mean(r.v_best[:nmu]))
        steer_ctrl = float(torch.mean(r.steering_best[:nmu]))
    with record_function("portbench.world"):
        a, st = world.actuation(v_ctrl, steer_ctrl, plant.state[2],
                                max(nmu - 1, 1) * cfg.horizon.dt, cfg.vehicle.steer_max,
                                cfg.noise.level, cfg.noise.acc_const, cfg.noise.steer_const,
                                s.noise)
        plant.step(a, st)
        s.step += 1
        if (plant.obstacle_margin() <= 0.0 or s.step >= int(s.ctx.params["max_steps"])
                or np.linalg.norm(plant.state[:2] - s.goal) < 7.0):
            new_episode(s)
        else:
            s.snap = plant.snapshot()


def graph_nodes(s):
    stats = s.solver.graph_stats()
    return max(stats, key=lambda g: g["replays"])["nodes"] if stats else None


def failed(s) -> int:
    return sum(1 for k in s.kept
               if not all(bool(torch.isfinite(f).all()) for f in k["out"]))


def free_program(s) -> None:
    s.solver = s.smoother = s.last = None


def compare(s, ctx) -> dict:
    """``compare`` steps of the window, drawn from the seed.  The reference
    works each step's local problem out again from the plant's and the
    obstacles' states and solves it from the step's warm-start mean and
    ``idx_mpc``.  With ``ctx.lower`` (the control) the program's side is the
    reference again, local problem and solve computed with TF32 on."""
    cfg, dev = ctx.ref_cfg, ctx.device
    n = min(int(ctx.params["compare"]), len(s.kept))
    pick = ctx.rng(2).choice(len(s.kept), size=n, replace=False)
    smoother = ref_smoother(cfg.frenet.num_path, device=dev)
    solver = RefFrenetSolver(cfg, device=dev)
    low = RefFrenetSolver(cfg, device=dev) if ctx.lower else None
    tot_time = torch.as_tensor(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num)
                               .astype(np.float32), device=dev)
    got: dict = {}
    raws = []
    for i in sorted(pick):
        k = s.kept[i]
        state, vdot, obstacles = k["snap"]
        plant = SimpleNamespace(spline=s.spline, state=state, vdot=vdot, obstacles=obstacles)

        def step(solver, lower):
            with maybe_tf32(lower):
                frame, x_obs, y_obs, init = ref_closedloop.local_problem(cfg, plant, smoother,
                                                                         tot_time)
                r = solver.solve(k["idx"], init, k["mean"], s.cov, x_obs, y_obs, s.v_des, frame)
            return dict(frame._asdict(), x_obs=x_obs, y_obs=y_obs, init=init), r
        local, rr = step(solver, False)
        out, got_local = k["out"], k["local"]
        if low is not None:
            got_local, out = step(low, True)
        collect(got, numbers(out._asdict(), rr._asdict(), k["mean"], s.cov))
        collect(got, {"frame_gap": [gap(got_local, local)]})
        if ctx.record:
            raws.append(raw(out._asdict(), rr._asdict(), k["mean"], s.cov))
    s.readings = dict(got, raw=raws)
    return reduce(got, ctx.params["limits"])
