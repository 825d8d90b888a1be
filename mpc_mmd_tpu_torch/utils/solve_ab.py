"""Single-solve latency and device work of two checkouts, timed in turns.

    python -m mpc_mmd_tpu_torch.utils.solve_ab --before DIR [--turns ABBA]
        [--solves 3] [--paths NAME ...] [--out DIR]

``--before DIR`` names the root of another checkout of this repository,
for example ``git archive <commit>`` unpacked under ``build/``.  Each turn
runs, in a fresh process and from one root's package, ``chip_smoke.py``'s
full-width fastrt ``mmd_opt`` solve, Path A's fused and "xla" solves,
Path B's ``cvar``, ``saa`` and ``mmd_random`` solves of that workload and
Path D's "xla" and ``det`` ``FrenetSolver`` solves (or those that
``--paths`` names; also the inner CEM's other selections: fastrt and Path
A under "xt" and "g", fastrt "xla" without elite-carry
(``MPC_MMD_ELITE_CARRY=0``), Path D fused, and the record's static
cells at N = 5 and 15 fused and at N = 15 "xla", ``chip_smoke.py``'s
``record_config``): one warm-up solve, ``--solves``
timed ones (wall ms to ``torch.cuda.synchronize``; their median and 99th
percentile over a root's turns) and one under ``torch.profiler`` (device
busy ms, idle share, device events); on the card each is a CUDA graph,
whose node count is recorded.  Then the Path D closed-loop steps
(``path_d_step`` in mmd_opt, ``path_d_det_step``): the solve times of two
20-step ``run_episode`` episodes on that solver, as ``chip_smoke.py`` 16b
runs them.  The turns take the roots in
the order ``--turns`` gives (``A`` the checkout this module is in, ``B``
the other), so a host that drifts during the call weighs on both.  Prints
one JSON line per turn and the medians per root, and writes
``solve_ab.json`` to ``--out`` (default ``build/solve_ab/``).  Needs a
CUDA card; runs on card 0.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "solve_ab"
PATHS = ("fastrt", "path_a_fused", "path_a_xla", "path_b_cvar", "path_b_saa",
         "path_b_mmd_random", "path_d_xla", "path_d_step", "path_d_det", "path_d_det_step",
         "fastrt_xt", "fastrt_g", "fastrt_nocarry", "path_a_xt", "path_a_g",
         "path_d_fused", "path_f5_fused", "path_f15_fused", "path_f15_xla")

# One turn: run from the root in argv[1], with that root's package and
# chip_smoke.py's problems.
WORKER = r"""
import glob, json, os, sys, tempfile, time
root, solves = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from mpc_mmd_tpu_torch import (FrenetSolver, Solver, dynamic_workload,
                               fastrt_workload, onroad_workload)
from mpc_mmd_tpu_torch.ops import _build
from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state
from mpc_mmd_tpu_torch.utils.observability import device_trace

dev = torch.device("cuda", 0)
_build.build()
_build.library()


def run(solve, solver):
    solve(0)
    torch.cuda.synchronize()
    ms = []
    for i in range(1, solves + 1):
        t0 = time.perf_counter()
        solve(i)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            solve(solves + 1)
        with open(glob.glob(os.path.join(d, "summary_*.json"))[0]) as f:
            s = json.load(f)
    return {"ms": ms, "device_busy_ms": s["device_busy_ms"],
            "idle_share": s["idle_share"], "device_events": s["device_events"],
            "graph_nodes": sum(g["nodes"] for g in solver.graph_stats())}


# the inner CEM's selection of a path: the environment its solves run in
SELECT = {"fastrt_xt": {"MPC_MMD_SELECTION": "xt"}, "fastrt_g": {"MPC_MMD_SELECTION": "g"},
          "fastrt_nocarry": {"MPC_MMD_ELITE_CARRY": "0"},
          "path_a_fused": {"MPC_MMD_FUSED_CEM": "1"}, "path_a_xt": {"MPC_MMD_SELECTION": "xt"},
          "path_a_g": {"MPC_MMD_SELECTION": "g"}, "path_d_fused": {"MPC_MMD_FUSED_CEM": "1"},
          "path_f5_fused": {"MPC_MMD_FUSED_CEM": "1"},
          "path_f15_fused": {"MPC_MMD_FUSED_CEM": "1"}}


def selected(name, fn):
    # fn() under the path's selection; the variables are read at call time
    env = SELECT.get(name, {})
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k in env:
            os.environ.pop(k, None)


paths = sys.argv[3].split(",")
out = {}
cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                      noise="gaussian", noise_level=0.1)
for name in ("fastrt", "fastrt_xt", "fastrt_g", "fastrt_nocarry"):
    if name not in paths:
        continue
    s = Solver(cfg, device=dev)
    scen = cs.obstacle_scenarios(torch, 4, 6, s.ws.tot_time)
    out[name] = selected(name, lambda: run(
        lambda i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen[i % 4], 15.0), s))
# the record's static cells (chip_smoke.py's Path F)
for name, N in (("path_f5_fused", 5), ("path_f15_fused", 15), ("path_f15_xla", 15)):
    if name not in paths:
        continue
    cf = cs.record_config(N)
    s = Solver(cf, device=dev)
    scen = cs.obstacle_scenarios(torch, 4, cf.obstacles.num_obs, s.ws.tot_time)
    out[name] = selected(name, lambda: run(
        lambda i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen[i % 4], 15.0), s))

cfg_a = dynamic_workload(num_reduced=10, num_obs=6, noise="beta", noise_level=0.2,
                         num_prime=50, mode="mmd_opt")
init, mean, cov, v_des = ego_initial_state("dynamic")
cut = dynamic_cutin(cfg_a, 3, device=dev)
# Path A under each selection, Path B's modes: the dynamic cut-in workload
for name, mode in (("path_a_fused", "mmd_opt"), ("path_a_xla", "mmd_opt"),
                   ("path_a_xt", "mmd_opt"), ("path_a_g", "mmd_opt"),
                   ("path_b_cvar", "cvar"), ("path_b_saa", "saa"),
                   ("path_b_mmd_random", "mmd_random")):
    if name not in paths:
        continue
    sa = Solver(cfg_a.with_risk_mode(mode), device=dev)
    out[name] = selected(name, lambda: run(
        lambda i: sa.solve(i, init, mean, cov, cut.x_traj[i % 3], cut.y_traj[i % 3],
                           v_des), sa))

cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50, noise="gaussian",
                        noise_level=0.1)
args = cs.onroad_problem(torch, cfg_d, dev)
from mpc_mmd_tpu_torch.closedloop import run_episode
# Path D in mmd_opt ("xla") and det, and each one's closed-loop step: the
# solve times of two 20-step episodes on that solver
for name, mode in (("path_d_xla", "mmd_opt"), ("path_d_det", "det"),
                   ("path_d_fused", "mmd_opt")):
    step = {"path_d_xla": "path_d_step", "path_d_det": "path_d_det_step"}.get(name)
    if name not in paths and step not in paths:
        continue
    c = cfg_d.with_risk_mode(mode)
    fs = FrenetSolver(c, device=dev)
    if name in paths:
        out[name] = selected(name, lambda: run(lambda i: fs.solve(i, *args), fs))
    if step in paths:
        steps = []
        for _ in range(2):
            r = run_episode(c, route_kind="curved", v_des=15.0, max_steps=20,
                            goal_arc=300.0, seed=0, solver=fs)
            steps += [1e3 * t for t in r.solve_times]
        out[step] = {"ms": steps}
print(json.dumps(out))
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before", required=True,
                   help="root of the other checkout (B)")
    p.add_argument("--turns", default="ABBA",
                   help="order of the turns, A = this checkout, B = --before")
    p.add_argument("--solves", type=int, default=3,
                   help="timed solves per path and turn")
    p.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS,
                   help="the solves to time")
    p.add_argument("--out", default=str(OUT_DIR))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("solve_ab: needs a CUDA card")
    roots = {"A": ROOT, "B": Path(a.before).resolve()}
    if set(a.turns) - set(roots):
        raise SystemExit(f"solve_ab: --turns takes A and B, got {a.turns!r}")
    for r in roots.values():
        if not (r / "chip_smoke.py").is_file():
            raise SystemExit(f"solve_ab: {r} holds no chip_smoke.py")
    turns = []
    for t in a.turns:
        run = subprocess.run([sys.executable, "-c", WORKER, str(roots[t]), str(a.solves),
                              ",".join(a.paths)],
                             cwd=roots[t], capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"solve_ab: turn {t} failed:\n{run.stderr[-4000:]}")
        rec = dict(json.loads(run.stdout.strip().splitlines()[-1]), root=t)
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    medians = {}
    for t in roots:
        mine = [r for r in turns if r["root"] == t]
        if mine:
            medians[t] = {path: {k: statistics.median(
                [x for r in mine for x in (r[path][k] if k == "ms" else [r[path][k]])])
                for k in ("ms", "device_busy_ms", "idle_share", "device_events",
                          "graph_nodes") if k in mine[0][path]}
                for path in mine[0] if path != "root"}
            for path, m in medians[t].items():       # and the tail of the times
                m["p99_ms"] = statistics.quantiles(
                    [x for r in mine for x in r[path]["ms"]], n=100,
                    method="inclusive")[98]
    print(json.dumps({"roots": {k: str(v) for k, v in roots.items()},
                      "medians": medians}), flush=True)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "solve_ab.json").write_text(json.dumps({"turns": turns, "medians": medians},
                                                  indent=1))


if __name__ == "__main__":
    main()
