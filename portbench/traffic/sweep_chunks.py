"""Traffic driver ``sweep_chunks``: a research sweep, each call a
``Solver(cfg, scenario_chunk=chunk).solve_batch`` of ``chunk`` fresh static
scenarios with the results copied to the host, as the sweep's accept step
reads them.

Parameters (``workloads/<cell>.json``): ``chunk``; ``pool``, ``warm``,
``traced_periods`` and ``limits`` as ``solve_stream``'s; ``compare`` chunks
of the window, drawn from the seed, solved again by the reference (a chunk
of the same size).  Each scenario's ``idx_mpc`` is a counter from a start
drawn from the seed.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
from torch.profiler import record_function

from portbench import world
from portbench.harness.compare import collect, maybe_tf32, numbers, raw, reduce
from portbench.reference.solver import Solver as RefSolver

FIELDS = ("cx", "cy", "risk_lane", "risk_obs", "beta", "sigma", "res_beta", "res", "res_2",
          "mean_param", "cov_param")


def build(ctx):
    from mpc_mmd_tpu_torch import Solver
    p = ctx.params
    chunk = int(p["chunk"])
    x, y = world.static_pool(ctx.rng(0), ctx.cfg.obstacles.num_obs, ctx.cfg.horizon.num,
                             int(p["pool"]))
    s = SimpleNamespace(ctx=ctx, chunk=chunk, x=x, y=y, init=world.ego_initial_state(),
                        solver=Solver(ctx.cfg, device=ctx.device, scenario_chunk=chunk),
                        k=0, idx=int(ctx.rng(1).integers(0, 2 ** 30)), kept=[], host={})
    for _ in range(int(p["warm"])):
        period(s, traced=True)
    return s


def _next(s):
    ks = [(s.k + j) % len(s.x) for j in range(s.chunk)]
    seeds = list(range(s.idx, s.idx + s.chunk))
    s.k += s.chunk
    s.idx += s.chunk
    return ks, seeds


def period(s, traced: bool = False) -> int:
    ks, seeds = _next(s)
    init_state, mean, cov, v_des = s.init
    with record_function("portbench.solve"):
        r = s.solver.solve_batch(seeds, init_state, mean, cov, s.x[ks], s.y[ks], v_des)
    with record_function("portbench.result_copy"):
        out = {f: getattr(r, f).cpu().numpy() for f in FIELDS}
    if not traced:
        s.kept.append((ks, seeds, out))
    return s.chunk


def between(s) -> None:
    pass


def graph_nodes(s):
    stats = s.solver.graph_stats()
    return max(stats, key=lambda g: g["replays"])["nodes"] if stats else None


def failed(s) -> int:
    return sum(int((~np.isfinite(np.concatenate([out[f].reshape(len(ks), -1) for f in FIELDS],
                                                 axis=1))).any(axis=1).sum())
               for ks, _, out in s.kept)


def free_program(s) -> None:
    s.solver = None


def compare(s, ctx) -> dict:
    """``compare`` chunks of the window, drawn from the seed, solved again by
    the reference (a chunk of the same size).  With ``ctx.lower`` (the
    control) the program's side is the reference again, computed with TF32
    on."""
    n = min(int(ctx.params["compare"]), len(s.kept))
    pick = ctx.rng(2).choice(len(s.kept), size=n, replace=False)
    ref = RefSolver(ctx.ref_cfg, device=ctx.device, scenario_chunk=s.chunk)
    low = (RefSolver(ctx.ref_cfg, device=ctx.device, scenario_chunk=s.chunk) if ctx.lower
           else None)
    init_state, mean, cov, v_des = s.init
    got: dict = {}
    raws = []
    for i in sorted(pick):
        ks, seeds, out = s.kept[i]
        args = (seeds, init_state, mean, cov, s.x[ks], s.y[ks], v_des)
        rr = ref.solve_batch(*args)
        if low is not None:
            with maybe_tf32(True):
                rl = low.solve_batch(*args)
            out = {f: getattr(rl, f) for f in FIELDS}
        mine = {f: getattr(rr, f) for f in FIELDS}
        collect(got, numbers(out, mine, mean, cov))
        if ctx.record:
            raws.append(raw(out, mine, mean, cov))
    s.readings = dict(got, raw=raws)
    return reduce(got, ctx.params["limits"])
