"""Prewarm a machine for the promoted presets: build the kernels, then
capture each (preset, mode, chunk) solve's CUDA graph.

Counterpart of ``mpc_mmd_tpu/cli/prewarm.py``.  The JAX tool fills the
persistent XLA compilation cache; here the cold start is the ``nvcc``
build of ``csrc/`` (``ops/_build.py``, keyed on a hash of the sources, so
a second run loads the library as it is), the library's load, and each
solve shape's first solve on the card: the eager warm-up (PyTorch's own
lazy initialisation, the kernels' one-time calls) and the capture and
instantiation of its CUDA graph (``graph.py``), which later solves of that
shape on the same solver replay:

    python -m mpc_mmd_tpu_torch.cli.prewarm                 # fastrt, default, realtime
    python -m mpc_mmd_tpu_torch.cli.prewarm --presets fastrt --num_reduced 10 \\
        --num_obs 6 --num_prime 50 --modes mmd_opt cvar --scenario_chunks 1 4

Prints one JSON line per (preset, mode, chunk): the wall time of its first
solve (``compile_or_hit_s``, the JAX tool's key), the graph's capture and
instantiation seconds and nodes, and the wall time of its first replay
(``first_replay_s``); then a summary line (``prewarmed``, ``total_s``,
``build_s``, ``load_s``).  The build's and the load's times also go to
standard error.  ``--device cpu`` builds nothing and runs the plain twins
eagerly (no graph, so no capture fields).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import resolve_device

PRESETS = ("fastrt", "default", "realtime", "fast")


def _make_cfg(preset: str, mode: str, num_reduced: int, num_obs: int,
              num_prime: int, noise: str, noise_level: float):
    from ..config import (fast_workload, fastrt_workload, realtime_workload,
                          static_workload)
    make = {"fastrt": fastrt_workload, "default": static_workload,
            "realtime": realtime_workload, "fast": fast_workload}[preset]
    return make(num_reduced=num_reduced, num_obs=num_obs,
                num_prime=num_prime, mode=mode, noise=noise,
                noise_level=noise_level)


def build_kernels():
    """Build (or find) the kernel library, then load it; (build, load)
    seconds."""
    from ..ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    t1 = time.perf_counter()
    _build.library()
    build_s, load_s = t1 - t0, time.perf_counter() - t1
    print(f"prewarm: kernels {path.name} built or found in {build_s:.1f} s, "
          f"loaded in {load_s:.2f} s", file=sys.stderr)
    return build_s, load_s


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    out.cx.cpu()                        # waits for the solve
    return time.perf_counter() - t0


def prewarm(presets, modes, num_reduced, num_obs, num_prime, noise,
            noise_level, device="cuda", scenario_chunks=(1,)) -> float:
    """The first solve and the first replay of each (preset, mode, chunk)
    on ``device`` (a chunk of 1 is ``solve``, more ``solve_batch``); their
    summed seconds."""
    from ..dynamics import constant_velocity_obstacles
    from ..solver import Solver

    dev = resolve_device(device)
    init_state = [0.0, 1.75, 5.0, 0.0, 0.0, 0.0]
    mean = [15.0] * 4 + [0.0] * 4
    cov = np.diag([20.0] * 4 + [100.0] * 4)
    total = 0.0
    for preset in presets:
        for mode in modes:
            cfg = _make_cfg(preset, mode, num_reduced, num_obs, num_prime,
                            noise, noise_level)
            for chunk in scenario_chunks:
                solver = Solver(cfg, device=dev, scenario_chunk=chunk)
                x0 = torch.linspace(35.0, 75.0, num_obs, device=dev)
                y0 = torch.tensor([-1.75, 1.75], device=dev).repeat(num_obs)[:num_obs]
                z = torch.zeros(num_obs, device=dev)
                xt, yt, _ = constant_velocity_obstacles(x0, y0, z, z, z,
                                                        solver.ws.tot_time)
                if chunk == 1:
                    solve = lambda s: solver.solve(s, init_state, mean, cov, xt, yt, 15.0)
                else:
                    xs, ys = xt.expand(chunk, -1, -1), yt.expand(chunk, -1, -1)
                    solve = lambda s: solver.solve_batch(
                        list(range(s, s + chunk)), init_state, mean, cov, xs, ys, 15.0)
                first = _timed(lambda: solve(0))
                again = _timed(lambda: solve(chunk))
                total += first
                line = {"preset": preset, "mode": mode, "chunk": chunk,
                        "compile_or_hit_s": round(first, 3)}
                for g in solver.graph_stats():
                    line.update(capture_s=round(g["capture_s"], 3),
                                instantiate_s=round(g["instantiate_s"], 3),
                                nodes=g["nodes"])
                line["first_replay_s" if solver.graph else "second_solve_s"] = \
                    round(again, 4)
                print(json.dumps(line), flush=True)
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--presets", nargs="+", default=["fastrt", "default",
                                                    "realtime"],
                   choices=PRESETS)
    p.add_argument("--modes", nargs="+", default=["mmd_opt"])
    p.add_argument("--num_reduced", type=int, default=10)
    p.add_argument("--num_obs", type=int, default=6)
    p.add_argument("--num_prime", type=int, default=50)
    p.add_argument("--noise", default="gaussian")
    p.add_argument("--noise_level", type=float, default=0.1)
    p.add_argument("--scenario_chunks", type=int, nargs="+", default=[1],
                   help="the chunk sizes to capture (1: solve; more: solve_batch)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    args = p.parse_args(argv)

    build_s = load_s = 0.0
    if resolve_device(args.device).type == "cuda":
        build_s, load_s = build_kernels()
    total = prewarm(args.presets, args.modes, args.num_reduced, args.num_obs,
                    args.num_prime, args.noise, args.noise_level, args.device,
                    args.scenario_chunks)
    print(json.dumps({"prewarmed": len(args.presets) * len(args.modes)
                      * len(args.scenario_chunks), "total_s": round(total, 1),
                      "build_s": round(build_s, 2), "load_s": round(load_s, 3)}))


if __name__ == "__main__":
    main()
