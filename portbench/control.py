"""The readings that a cell's limits are set from, on the card: the compared
numbers of the program on many seeds; of the control on several: the
plain reference put in the program's place, computed with TF32 on (the
precision below the configurations' float32 with TF32 off), on the same
sampled calls or steps of the window as the program's; and of the program
with a fault of ``harness/faults.py`` planted under its timed path.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --seconds 3 \
        [--control | --fault <name>] [--out <file.jsonl>]

Each seed is a short run of the cell (set-up, a window of ``--seconds``,
the comparison) in this one process; prints one JSON line a seed, and with
``--out`` appends it there with both sides' compared values (``raw``).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench.harness.faults import FAULTS, plant  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    import torch
    from portbench.harness.cell import run_cell
    from portbench.harness.spec import Spec
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    if args.fault:
        plant(args.fault)
    spec = Spec()
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = {}
        r = run_cell(spec, cell, seed, args.seconds, False, torch.device("cuda"), t0,
                     lower=args.control, readings=readings)
        line = {"workload": args.workload, "control": args.control, "fault": args.fault,
                "seed": seed, "periods": r["seconds"]["periods"],
                "compare_s": r["seconds"]["compare"], "correct": r["correct"],
                "compared": r["compared"]}
        raws = readings.pop("raw", [])
        print(json.dumps(dict(line, readings=readings)), flush=True)
        if args.out:
            with args.out.open("a") as f:
                f.write(json.dumps(dict(line, readings=readings, raw=raws)) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
