"""The stages of an outer iteration: their launches and device time on
the card, eagerly and in the CUDA graph's replay.

    python -m mpc_mmd_tpu_torch.utils.inner_split [--root DIR] [--out DIR]
        [--paths NAME ...]

Runs, in a fresh process and from the package under ``--root`` (default:
this checkout; another one is, for example, ``git archive <commit>``
unpacked under ``build/``), ``chip_smoke.py``'s full-width fastrt
``mmd_opt`` solve, Path A's "xla" solve, Path B's ``cvar``, ``saa`` and
``mmd_random`` solves of the same workload, Path D's "xla" and ``det``
``FrenetSolver`` solves and the fastrt solve at a scenario chunk of 4
(E4), or those that ``--paths`` names (also the inner CEM's other
selections, as ``utils/solve_ab.py`` names them: fastrt and Path A under
"xt" and "g", fastrt "xla" without elite-carry, Path A and Path D fused,
the record's static cells at N = 5 and 15 fused and at N = 15 "xla"):

- eagerly (``graph=False``): one warm-up solve, then one under
  ``torch.profiler`` with every call of each stage function (``STAGES``:
  the guess QP, the projection, the controls, the noisy controls, the
  rollouts, the refit, the inner CEM's prologue with kernel (c) inside,
  the reduced rollouts' gathers after it (``take_rows``), the inner
CEM's chain where the solver keeps it (``inner_cem_plain``: its K1, K2,
K2t and K3 calls, ``beta_qp`` and ``resample``), the Frenet
  conversion, the risks of every mode, the projection's obstacle terms,
  the chains of kernels (d) and (e) where the solver keeps them
  (``outer_project_plain``, ``chain_tail``), the costs, the CEM update,
  the argsorts; and
  where the checkout has them kernels (d) and (e), the rollout draws with
  K4n and kernels (f) and (g)) inside a ``record_function`` range
  that opens and closes with ``torch.cuda.synchronize()``, so that the
  device events that start in a range are that call's and no other's (an
  event belongs to the innermost range it starts in; those in none are
  the gathers and the rest of the loop's glue).  Reports each stage's
  device events and busy ms, and their shares;
- graphed (the default on the card): the first solve captures, the
  graph's node count is read from ``graph_stats()``, and one replay runs
  under ``torch.profiler``: its device busy ms, each stage's replay
  time (each kernel's mean time in the replay times its count in the
  stage's eager calls), and kernels (c) to (g) and K4n's device ms and
  launches in the replay (``replay_kernels``).

Prints one JSON line with every path and writes ``inner_split.json`` to
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
PATHS = ("fastrt", "e4", "path_a_xla", "path_b_cvar", "path_b_saa", "path_b_mmd_random",
         "path_d_xla", "path_d_det", "fastrt_xt", "fastrt_g", "fastrt_nocarry",
         "path_a_fused", "path_a_xt", "path_a_g", "path_d_fused", "path_f5_fused",
         "path_f15_fused", "path_f15_xla")

WORKER = r"""
import importlib, json, os, sys
root = sys.argv[1]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile, record_function
import chip_smoke as cs
from mpc_mmd_tpu_torch import (FrenetSolver, Solver, dynamic_workload,
                               fastrt_workload, onroad_workload)
from mpc_mmd_tpu_torch.ops import _build
from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state

# (module, function) of each stage, as the checkout calls it; a stage the
# checkout does not have is left out.  Nested: the inner CEM's kernel (c)
# and the gathers of its winners' rollouts inside select_reduced_set_batched,
# the refit inside select_reduced.
STAGES = [("solver", "compute_guess"), ("qp", "compute_guess"),
          ("solver", "project"), ("projection", "project"),
          ("solver", "controls_from_trajectory"), ("dynamics", "controls_from_trajectory"),
          ("solver", "outer_project"), ("solver", "outer_tail"),
          ("solver", "noisy_controls"), ("solver_frenet", "noisy_controls"),
          ("solver", "batched_rollouts"), ("solver_frenet", "batched_rollouts"),
          ("solver", "rollout_draws"), ("solver", "solve_draws"),
          ("solver", "noisy_rollout"),
          ("solver", "refit_coefficients"), ("solver", "inner_prologue"),
          ("solver", "select_reduced_set_batched"),
          ("reduced_set", "inner_cem"), ("reduced_set", "take_rows"),
          ("reduced_set", "inner_cem_plain"),
          # the inner CEM's chains: in reduced_set.py before they were forms
          # of kernel (c), in ops/inner_cem.py since
          ("reduced_set", "topk_kernel_matrices"), ("reduced_set", "topk_indices"),
          ("reduced_set", "eq_qp_solve_t"), ("reduced_set", "beta_qp"),
          ("reduced_set", "resample"), ("ops.inner_cem", "topk_kernel_matrices"),
          ("ops.inner_cem", "topk_indices"), ("ops.inner_cem", "eq_qp_solve_t"),
          ("ops.inner_cem", "beta_qp"), ("ops.inner_cem", "resample"),
          ("solver_frenet", "global_to_frenet_points"), ("solver_frenet", "frenet_points"),
          ("solver_frenet", "initial_states"), ("solver_frenet", "frenet_states"),
          ("risk", "mmd_obs"), ("risk", "mmd_lane"), ("risk", "mmd_lane_des"),
          ("solver", "scalar_cost"), ("sampling", "scalar_cost"),
          ("solver_frenet", "frenet_scalar_cost"), ("sampling", "frenet_scalar_cost"),
          ("solver", "cem_update"), ("sampling", "cem_update"),
          ("solver", "outer_project_plain"), ("solver", "chain_tail"),
          ("risk", "cvar_obs"), ("risk", "saa_obs"), ("risk", "cvar_lane"),
          ("risk", "saa_lane"), ("risk", "cvar_lane_des"), ("risk", "saa_lane_des"),
          ("projection", "_obs_polar"), ("projection", "_obs_residuals")]
dev = torch.device("cuda", 0)
_build.build()
_build.library()


def ranged(name, fn):
    def call(*args, **kw):
        torch.cuda.synchronize()
        with record_function(name):
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        return out
    return call


class Sorts:
    # torch for the modules that sort, their argsorts in a range
    def __getattr__(self, name):
        return getattr(torch, name)

    def argsort(self, *a, **kw):
        return ranged("argsort", torch.argsort)(*a, **kw)


def install():
    undo = []
    for mod, name in STAGES:
        m = importlib.import_module(f"mpc_mmd_tpu_torch.{mod}")
        fn = getattr(m, name, None)
        if callable(fn):
            undo.append((m, name, fn))
            setattr(m, name, ranged(name, fn))
    for mod in ("solver", "sampling"):
        m = importlib.import_module(f"mpc_mmd_tpu_torch.{mod}")
        undo.append((m, "torch", m.torch))
        m.torch = Sorts()
    return undo


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


def split(make, solve):
    eager = make(False)
    solve(eager, 0)
    torch.cuda.synchronize()
    undo = install()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve(eager, 1)
            torch.cuda.synchronize()
    finally:
        for m, name, fn in reversed(undo):
            setattr(m, name, fn)
    events = prof.events()
    names = {name for _, name in STAGES} | {"argsort"}
    ranges = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.name in names and e.device_type == torch.autograd.DeviceType.CPU]
    dev_ev = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in names]

    def stage_of(t):
        inside = [(b - a, n) for a, b, n in ranges if a <= t <= b]
        return min(inside)[1] if inside else "gathers and glue"

    per = {}
    for ev in dev_ev:
        per.setdefault(stage_of(ev[0]), []).append(ev)
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
    busy = union_ms([(lo, hi) for lo, hi, _ in dev_ev])
    replay_busy = union_ms([(lo, hi) for lo, hi, _ in replay])
    stages = {}
    for stage, evs in per.items():
        # the replay's time of the stage's kernels: each kernel's mean time
        # in the replay times its count in the stage's eager calls
        rep = sum(n * replay_by_name[name][0] / replay_by_name[name][1]
                  for name, (_, n) in by_name(evs).items() if name in replay_by_name)
        stages[stage] = {"calls": sum(1 for r in ranges if r[2] == stage),
                         "events": len(evs),
                         "busy_ms": union_ms([(lo, hi) for lo, hi, _ in evs]),
                         "replay_ms": rep}
    stats = graphed.graph_stats()
    return {"device_busy_ms": busy, "device_events": len(dev_ev),
            "graph_nodes": [g["nodes"] for g in stats], "replay_busy_ms": replay_busy,
            "replay_events": len(replay),
            # kernels (c) to (g) and K4n in the replay: device ms and launches
            "replay_kernels": {name: [ms, n] for name, (ms, n) in replay_by_name.items()
                               if any(k in name for k in (
                                   "inner_cem", "outer_project", "outer_tail",
                                   "noisy_rollout", "inner_prologue", "frenet_points",
                                   "frenet_states",
                                   "topk", "eq_qp"))},
            "stages": dict(sorted(stages.items(), key=lambda kv: -kv[1]["events"]))}


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


paths = sys.argv[2].split(",")
out = {"device": torch.cuda.get_device_name(0)}
cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                      noise="gaussian", noise_level=0.1)
cfg_a = dynamic_workload(num_reduced=10, num_obs=6, noise="beta", noise_level=0.2,
                         num_prime=50, mode="mmd_opt")
cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50, noise="gaussian",
                        noise_level=0.1)
if {"fastrt", "e4", "fastrt_xt", "fastrt_g", "fastrt_nocarry"} & set(paths):
    probe = Solver(cfg, device=dev, graph=False)
    scen = cs.obstacle_scenarios(torch, 8, 6, probe.ws.tot_time)
    xs = torch.stack([x for x, _ in scen])
    ys = torch.stack([y for _, y in scen])
for name in ("fastrt", "fastrt_xt", "fastrt_g", "fastrt_nocarry"):
    if name in paths:
        out[name] = selected(name, lambda: split(
            lambda g: Solver(cfg, device=dev, graph=g),
            lambda s, i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen[i], 15.0)))
if "e4" in paths:
    out["e4"] = split(lambda g: Solver(cfg, device=dev, graph=g, scenario_chunk=4),
                      lambda s, i: s.solve_batch([4 * i + j for j in range(4)], cs.INIT,
                                                 cs.MEAN, cs.COV, xs[4 * i:4 * i + 4],
                                                 ys[4 * i:4 * i + 4], 15.0))
init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
cut = dynamic_cutin(cfg_a, 2, device=dev)
# Path A under each selection and Path B's modes: the dynamic cut-in workload
for name, mode in (("path_a_xla", "mmd_opt"), ("path_a_fused", "mmd_opt"),
                   ("path_a_xt", "mmd_opt"), ("path_a_g", "mmd_opt"),
                   ("path_b_cvar", "cvar"), ("path_b_saa", "saa"),
                   ("path_b_mmd_random", "mmd_random")):
    if name in paths:
        c = cfg_a.with_risk_mode(mode)
        out[name] = selected(name, lambda: split(
            lambda g, c=c: Solver(c, device=dev, graph=g),
            lambda s, i: s.solve(i, init_d, mean_d, cov_d, cut.x_traj[i], cut.y_traj[i],
                                 v_des)))
args = cs.onroad_problem(torch, cfg_d, dev)
# Path D: the on-road FrenetSolver in mmd_opt ("xla", fused) and det
for name, mode in (("path_d_xla", "mmd_opt"), ("path_d_det", "det"),
                   ("path_d_fused", "mmd_opt")):
    if name in paths:
        c = cfg_d.with_risk_mode(mode)
        out[name] = selected(name, lambda: split(
            lambda g, c=c: FrenetSolver(c, device=dev, graph=g),
            lambda s, i: s.solve(i, *args)))
# the record's static cells (chip_smoke.py's Path F)
for name, N in (("path_f5_fused", 5), ("path_f15_fused", 15), ("path_f15_xla", 15)):
    if name in paths:
        cf = cs.record_config(N)
        probe = Solver(cf, device=dev, graph=False)
        scen_f = cs.obstacle_scenarios(torch, 2, cf.obstacles.num_obs, probe.ws.tot_time)
        out[name] = selected(name, lambda: split(
            lambda g, c=cf: Solver(c, device=dev, graph=g),
            lambda s, i: s.solve(i, cs.INIT, cs.MEAN, cs.COV, *scen_f[i], 15.0)))
print(json.dumps(out))
"""


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="root of the checkout whose package runs")
    p.add_argument("--out", default=str(OUT_DIR))
    p.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS,
                   help="the solves to split")
    a = p.parse_args(argv)
    root = Path(a.root).resolve()
    if not (root / "chip_smoke.py").is_file():
        raise SystemExit(f"inner_split: {root} holds no chip_smoke.py")
    run = subprocess.run([sys.executable, "-c", WORKER, str(root), ",".join(a.paths)],
                         cwd=root,
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
