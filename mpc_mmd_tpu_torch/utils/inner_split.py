"""The inner beta-CEM's share of a solve's device time, device events and
CUDA graph nodes, on the card.

    python -m mpc_mmd_tpu_torch.utils.inner_split [--root DIR] [--out DIR]

Runs, in a fresh process and from the package under ``--root`` (default:
this checkout; another one is, for example, ``git archive <commit>``
unpacked under ``build/``), ``chip_smoke.py``'s full-width fastrt
``mmd_opt`` solve and Path D's "xla" ``FrenetSolver`` solve:

- eagerly (``graph=False``): one warm-up solve, then one under
  ``torch.profiler`` with every call of ``select_reduced_set_batched``
  inside a ``record_function`` range that opens and closes with
  ``torch.cuda.synchronize()``, so that the device events that start in a
  range are that call's and no other's.  Reports the device busy ms and
  device events of the solve and of the ranges, and their shares;
- graphed (the default on the card): the first solve captures, the
  graph's node count is read from ``graph_stats()``, and one replay runs
  under ``torch.profiler``: its device busy ms, and the replay time of the
  inner calls' kernels, each kernel's mean time in the replay times its
  count in the eager inner calls.

Prints one JSON line per path and writes ``inner_split.json`` to
``--out`` (default ``build/inner_split/``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "inner_split"

WORKER = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile, record_function
import chip_smoke as cs
from mpc_mmd_tpu_torch import FrenetSolver, Solver, fastrt_workload, onroad_workload
from mpc_mmd_tpu_torch import solver as solver_mod
from mpc_mmd_tpu_torch.ops import _build

RANGE = "select_reduced_set_batched"
dev = torch.device("cuda", 0)
_build.build()
_build.library()
inner = solver_mod.select_reduced_set_batched


def ranged(*args, **kw):
    torch.cuda.synchronize()
    with record_function(RANGE):
        out = inner(*args, **kw)
        torch.cuda.synchronize()
    return out


def union_ms(spans):
    busy, end = 0.0, -float("inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def by_name(events):
    # {kernel name: (device ms, count)}
    out = {}
    for lo, hi, name in events:
        ms, n = out.get(name, (0.0, 0))
        out[name] = (ms + (hi - lo) / 1e3, n + 1)
    return out


def top(table, n=10):
    return [[name[:80], round(ms, 3), cnt] for name, (ms, cnt) in
            sorted(table.items(), key=lambda kv: -kv[1][0])[:n]]


def split(make, solve):
    eager = make(False)
    solve(eager, 0)
    torch.cuda.synchronize()
    solver_mod.select_reduced_set_batched = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve(eager, 1)
            torch.cuda.synchronize()
    finally:
        solver_mod.select_reduced_set_batched = inner
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.name == RANGE and e.device_type == torch.autograd.DeviceType.CPU]
    # the range itself is also recorded on the device's timeline: left out
    dev_ev = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name != RANGE]
    inside = [(lo, hi) for lo, hi, _ in dev_ev
              if any(a <= lo <= b for a, b in ranges)]
    inner_by_name = by_name([e for e in dev_ev
                             if any(a <= e[0] <= b for a, b in ranges)])
    graphed = make(True)
    solve(graphed, 0)
    solve(graphed, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(graphed, 1)
        torch.cuda.synchronize()
    replay = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    replay_by_name = by_name(replay)
    # the replay's time of the inner calls' kernels: each kernel's mean time
    # in the replay times its count in the eager inner calls
    inner_replay = sum(n * replay_by_name[name][0] / replay_by_name[name][1]
                       for name, (_, n) in inner_by_name.items()
                       if name in replay_by_name)
    stats = graphed.graph_stats()
    busy, busy_in = union_ms([(lo, hi) for lo, hi, _ in dev_ev]), union_ms(inside)
    replay_busy = union_ms([(lo, hi) for lo, hi, _ in replay])
    return {"inner_calls": len(ranges), "device_busy_ms": busy,
            "inner_busy_ms": busy_in, "inner_busy_share": busy_in / busy,
            "device_events": len(dev_ev), "inner_events": len(inside),
            "inner_event_share": len(inside) / len(dev_ev),
            "graph_nodes": [g["nodes"] for g in stats],
            "replay_busy_ms": replay_busy, "replay_events": len(replay),
            "replay_inner_kernel_ms": inner_replay,
            "replay_inner_share": inner_replay / replay_busy,
            "top_inner_eager": top(inner_by_name), "top_replay": top(replay_by_name)}


out = {"device": torch.cuda.get_device_name(0)}
cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                      noise="gaussian", noise_level=0.1)
probe = Solver(cfg, device=dev, graph=False)
scen = cs.obstacle_scenarios(torch, 2, 6, probe.ws.tot_time)
out["fastrt"] = split(lambda g: Solver(cfg, device=dev, graph=g),
                      lambda s, i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen[i], 15.0))
cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50, noise="gaussian",
                        noise_level=0.1)
args = cs.onroad_problem(torch, cfg_d, dev)
out["path_d_xla"] = split(lambda g: FrenetSolver(cfg_d, device=dev, graph=g),
                          lambda s, i: s.solve(i, *args))
print(json.dumps(out))
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="root of the checkout whose package runs")
    p.add_argument("--out", default=str(OUT_DIR))
    a = p.parse_args(argv)
    root = Path(a.root).resolve()
    if not (root / "chip_smoke.py").is_file():
        raise SystemExit(f"inner_split: {root} holds no chip_smoke.py")
    run = subprocess.run([sys.executable, "-c", WORKER, str(root)], cwd=root,
                         capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"inner_split: failed:\n{run.stderr[-4000:]}")
    rec = dict(json.loads(run.stdout.strip().splitlines()[-1]), root=str(root))
    print(json.dumps(rec), flush=True)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "inner_split.json").write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
