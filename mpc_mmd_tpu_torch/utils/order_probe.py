"""The summation orders that kernel (h) copies, probed on the card.

    python -m mpc_mmd_tpu_torch.utils.order_probe [--out DIR]

Kernel (h) (``csrc/local_frame.cu``) gives its chain's bits only while it
sums as the chain's kernels do on this card and software: ``torch.mv`` of
the smoother's (n + 1)-square KKT inverse (cuBLAS's gemv) and
``torch.cumsum`` of a 1-d tensor (CUB's DeviceScan).  This tool finds and
checks those orders:

* the kernels each call launches (``torch.profiler``'s names);
* FPRev's probe of a sum's tree: a row of ones with M = 2^35 at term i
  and -M at term j sums to the number of ones outside the smallest
  subtree that holds both (M absorbs every partial sum below 2^11), so a
  row's result gives that subtree's size.  For a width N it probes every
  pair (0, j), and, for cuBLAS's switch between its two orders, whether
  terms 0 and 1 meet first (one lane's block) at each width from 514 to
  577 columns;
* the twins ``ops.local_frame.gemv_rows`` and ``cub_cumsum`` against the
  calls on the card, bit for bit, on random inputs from a seeded numpy
  generator at widths on both sides of the switch.

Writes ``order_probe.json`` to ``--out``; exits 1 if a twin is not
bit-equal.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.local_frame import STRIDED_FROM, cub_cumsum, gemv_rows

M_BIG = 2.0 ** 35
GEMV_WIDTHS = (65, 129, 257, 513, 515, 516, 577, 601, 640)
SCAN_LENGTHS = (64, 599, 600, 639)


def kernel_names(fn) -> list:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def subtree_sizes(N: int) -> list:
    """FPRev on torch.mv at width N: for each j > 0, the size of the
    smallest subtree of row 0's sum holding terms 0 and j."""
    dev = torch.device("cuda")
    x = torch.ones(N, device=dev)
    A = torch.ones((N, N), device=dev)
    rows = torch.arange(1, N, device=dev)
    A[rows, 0] = M_BIG          # row j pairs term 0 with term j
    A[rows, rows] = -M_BIG
    y = (A @ x)[1:]
    return [int(N - v) for v in y.round().tolist()]


def meets_first(N: int) -> bool:
    """Whether terms 0 and 1 of a row meet first in torch.mv at width N."""
    dev = torch.device("cuda")
    A = torch.ones((N, N), device=dev)
    A[0, 0], A[0, 1] = M_BIG, -M_BIG
    return float((A @ torch.ones(N, device=dev))[0]) == N - 2


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", type=Path, default=Path("build") / "order_probe")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("order_probe needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rec = {"card": smi.stdout.strip(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"card: {rec['card']}; torch {rec['torch']}, CUDA {rec['cuda']}", flush=True)
    A601, x601 = torch.ones((601, 601), device=dev), torch.ones(601, device=dev)
    v600 = torch.rand(600, device=dev)
    rec["kernels"] = {"mv 601": kernel_names(lambda: A601 @ x601),
                      "cumsum 600": kernel_names(lambda: torch.cumsum(v600, 0))}
    print(f"kernels: {rec['kernels']}", flush=True)
    rec["subtree_sizes"] = {}
    for N in (65, 601):
        sizes = subtree_sizes(N)
        rec["subtree_sizes"][N] = sizes
        first = [j + 1 for j, s in enumerate(sizes) if s == 2]
        print(f"mv width {N}: term 0 meets term(s) {first} first; subtree sizes met "
              f"{sorted(set(sizes))}", flush=True)
    blocked = {N: meets_first(N) for N in range(514, 578)}
    switch = min((N for N, b in blocked.items() if not b), default=None)
    rec["strided_from"] = switch
    rec["blocked_again_after_switch"] = [N for N, b in blocked.items()
                                         if switch and N > switch and b]
    print(f"mv: lanes 32 apart from {switch} columns (ops.local_frame.STRIDED_FROM "
          f"{STRIDED_FROM}); blocked again after it at {rec['blocked_again_after_switch']}",
          flush=True)
    rng = np.random.default_rng(22)
    bad = {}
    for N in GEMV_WIDTHS:
        A = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)).to(dev)
        apart = 0
        for _ in range(8):
            x = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
            apart += int((gemv_rows(A, x) != A @ x).sum())
        bad[f"mv {N}"] = apart
    for n in SCAN_LENGTHS:
        apart = 0
        for scale in (1.0, 1e-3, 1e3):
            v = torch.from_numpy((scale * rng.uniform(0.3, 0.7, n)).astype(np.float32)).to(dev)
            apart += int((cub_cumsum(v) != torch.cumsum(v, 0)).sum())
        bad[f"cumsum {n}"] = apart
    rec["twin_entries_apart"] = bad
    print(f"twins against the card's calls, entries apart: {bad}", flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "order_probe.json").write_text(json.dumps(rec, indent=1))
    ok = switch == STRIDED_FROM and not rec["blocked_again_after_switch"] and not any(
        bad.values())
    print(json.dumps({"order_probe_ok": ok}), flush=True)
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
