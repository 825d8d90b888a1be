"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and traffic;
``workloads/<cell>.json`` names the traffic driver (``traffic/<driver>.py``)
and its parameters, ``configs/<config>.json`` the configuration.  A run
builds the cell's solver and inputs from the seed and warms every shape it
will use (set-up), drives the traffic for ``--seconds`` (the window),
with ``--trace 1`` then profiles a bounded stretch of periods, frees the
program's state, compares a sample of the window's outputs with the plain
reference (``reference/``), and prints one JSON line: its end-to-end
metrics untraced, its per-layer metrics traced.  Without a CUDA card with
as many cards as the cell asks for, it exits 2 and prints no result; if a
module of JAX or of the JAX package is loaded at the end, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "portbench_cache"


def environment() -> None:
    """Caches inside the checkout at fixed paths; the inner CEM's selection
    and chunking as the configuration runs them (the port reads these at
    call time); no JAX behind a library's back."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for name in ("MPC_MMD_SELECTION", "MPC_MMD_FUSED_CEM", "MPC_MMD_ELITE_CARRY",
                 "MPC_MMD_SCENARIO_CHUNK"):
        os.environ.pop(name, None)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    environment()
    args = parse(argv)
    if str(CHECKOUT) not in sys.path:
        sys.path.insert(0, str(CHECKOUT))
    import torch
    from portbench.harness.spec import Spec
    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    from portbench.harness.cell import run_cell
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START)
    return report(result)


def report(result) -> int:
    """Prints the compared numbers as the last lines of standard error and
    the result as the last line of standard output; 3 (and no result) if a
    module of JAX or of the JAX package is loaded."""
    from portbench.harness.nojax import loaded
    found = loaded()
    if found:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} against the limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
