"""Single-solve latency and device work of two checkouts, timed in turns.

    python -m mpc_mmd_tpu_torch.utils.solve_ab --before DIR [--turns ABBA]
        [--solves 3] [--out DIR]

``--before DIR`` names the root of another checkout of this repository,
for example ``git archive <commit>`` unpacked under ``build/``.  Each turn
runs, in a fresh process and from one root's package, ``chip_smoke.py``'s
full-width fastrt ``mmd_opt`` solve, Path A's fused solve and Path D's
"xla" ``FrenetSolver`` solve: one warm-up solve, ``--solves`` timed ones
(wall ms to ``torch.cuda.synchronize``) and one under ``torch.profiler``
(device busy ms, idle share, device events).  The turns take the roots in
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


def run(solve):
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
            "idle_share": s["idle_share"], "device_events": s["device_events"]}


out = {}
cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                      noise="gaussian", noise_level=0.1)
s = Solver(cfg, device=dev)
scen = cs.obstacle_scenarios(torch, 4, 6, s.ws.tot_time)
out["fastrt"] = run(lambda i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen[i % 4], 15.0))

cfg_a = dynamic_workload(num_reduced=10, num_obs=6, noise="beta", noise_level=0.2,
                         num_prime=50, mode="mmd_opt")
init, mean, cov, v_des = ego_initial_state("dynamic")
cut = dynamic_cutin(cfg_a, 3, device=dev)
os.environ["MPC_MMD_FUSED_CEM"] = "1"
sa = Solver(cfg_a, device=dev)
out["path_a_fused"] = run(lambda i: sa.solve(i, init, mean, cov, cut.x_traj[i % 3],
                                             cut.y_traj[i % 3], v_des))
os.environ.pop("MPC_MMD_FUSED_CEM")

cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50, noise="gaussian",
                        noise_level=0.1)
args = cs.onroad_problem(torch, cfg_d, dev)
fs = FrenetSolver(cfg_d, device=dev)
out["path_d_xla"] = run(lambda i: fs.solve(i, *args))
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
        run = subprocess.run([sys.executable, "-c", WORKER, str(roots[t]), str(a.solves)],
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
                for k in ("ms", "device_busy_ms", "idle_share", "device_events")}
                for path in mine[0] if path != "root"}
    print(json.dumps({"roots": {k: str(v) for k, v in roots.items()},
                      "medians": medians}), flush=True)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "solve_ab.json").write_text(json.dumps({"turns": turns, "medians": medians},
                                                  indent=1))


if __name__ == "__main__":
    main()
