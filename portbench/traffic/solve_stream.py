"""Traffic driver ``solve_stream``: one caller in a closed loop, each call a
``Solver.solve`` of a fresh static scenario, up to ``torch.cuda.synchronize()``.

Parameters (``workloads/<cell>.json``): ``pool`` scenarios drawn on the
static grid from the seed in set-up and used in turn; ``warm`` calls in
set-up (the first captures the solve's CUDA graph); ``compare`` calls of
the window, drawn from the seed, solved again by the reference,
``compare_chunk`` of them (1 if not given) as one ``solve_batch``;
``traced_periods`` calls in the traced stretch; ``limits``.  Each call's
``idx_mpc`` (its noise) is a counter from a start drawn from the seed.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
from torch.profiler import record_function

from portbench import world
from portbench.harness.compare import collect, maybe_tf32, numbers, raw, reduce
from portbench.reference.solver import Solver as RefSolver


def build(ctx):
    from mpc_mmd_tpu_torch import Solver
    p = ctx.params
    x, y = world.static_pool(ctx.rng(0), ctx.cfg.obstacles.num_obs, ctx.cfg.horizon.num,
                             int(p["pool"]))
    init_state, mean, cov, v_des = world.ego_initial_state()
    s = SimpleNamespace(ctx=ctx, solver=Solver(ctx.cfg, device=ctx.device), x=x, y=y,
                        init=(init_state, mean, cov, v_des), k=0,
                        idx=int(ctx.rng(1).integers(0, 2 ** 30)), kept=[], host={})
    for _ in range(int(p["warm"])):
        period(s, traced=True)
    return s


def period(s, traced: bool = False) -> int:
    k = s.k % len(s.x)
    init_state, mean, cov, v_des = s.init
    with record_function("portbench.solve"):
        r = s.solver.solve(s.idx, init_state, mean, cov, s.x[k], s.y[k], v_des)
        s.ctx.sync()
    if not traced:
        s.kept.append((k, s.idx, r))
    s.k += 1
    s.idx += 1
    return 1


def between(s) -> None:
    pass


def graph_nodes(s):
    stats = s.solver.graph_stats()
    return max(stats, key=lambda g: g["replays"])["nodes"] if stats else None


def failed(s) -> int:
    return sum(1 for _, _, r in s.kept
               if not all(bool(np.isfinite(np.asarray(f.cpu())).all()) for f in r))


def free_program(s) -> None:
    s.solver = None


def compare(s, ctx) -> dict:
    """``compare`` calls of the window, drawn from the seed, solved again by
    the reference from the same scenario, ``idx_mpc``, state and moments,
    ``compare_chunk`` calls at a time as one ``solve_batch`` of the reference.
    With ``ctx.lower`` (the control) the program's side is the reference
    again, computed with TF32 on."""
    n = min(int(ctx.params["compare"]), len(s.kept))
    pick = sorted(ctx.rng(2).choice(len(s.kept), size=n, replace=False))
    c = int(ctx.params.get("compare_chunk", 1))
    ref = RefSolver(ctx.ref_cfg, device=ctx.device, scenario_chunk=c)
    low = RefSolver(ctx.ref_cfg, device=ctx.device, scenario_chunk=c) if ctx.lower else None
    init_state, mean, cov, v_des = s.init
    got: dict = {}
    raws = []
    for lo in range(0, n, c):
        block = [s.kept[i] for i in pick[lo:lo + c]]
        ks = [k for k, _, _ in block]
        args = ([idx for _, idx, _ in block], init_state, mean, cov, s.x[ks], s.y[ks], v_des)
        rr = ref.solve_batch(*args)
        outs = [r._asdict() for _, _, r in block]
        if low is not None:
            with maybe_tf32(True):
                rl = low.solve_batch(*args)
            outs = [{f: v[j] for f, v in rl._asdict().items()} for j in range(len(block))]
        for j, out in enumerate(outs):
            mine = {f: v[j] for f, v in rr._asdict().items()}
            collect(got, numbers(out, mine, mean, cov))
            if ctx.record:
                raws.append(raw(out, mine, mean, cov))
    s.readings = dict(got, raw=raws)
    return reduce(got, ctx.params["limits"])
