"""Hold the port's sweep and validation against the JAX record of one cell.

    python -m mpc_mmd_tpu_torch.utils.record_check --out DIR [--device cuda]
    python -m mpc_mmd_tpu_torch.utils.record_check --out DIR --device cpu \
        --workers 5 [--beside CARD_DIR/data]

The cell: the static workload, gaussian noise 0.1, N = 10, 6 obstacles,
ts 50, 200 configs, ``mmd_opt`` and ``cvar`` at the record's budgets (the
presets' defaults, ``artifacts/acceptance/run_static_r3.sh``).  The port
sweeps it (``--dispatch batch``, 8 scenarios an outer loop: the pipeline's
results), runs ``validate --compare`` at n_mc 1000 on its own stores, and
validates the record's stores too, then compares with the record
(``artifacts/acceptance/data_static/...`` and ``stats_static/...``):

* accepted scenarios per mode, and their overlap with the record's (a
  scenario is its seed, unique among the record's accepted);
* n_common and the collision % of each mode, against the record's, with
  the Monte-Carlo band: 3 standard errors of the mean of per-scenario
  collision fractions (binomial, n_mc rollouts each, at the record's
  fractions);
* the record's own stores validated by the port: the same solves and the
  same draws (the JAX key chain), so the collision % differs only by the
  rollouts' round-off on another device;
* with ``--beside``, the accepted scenarios per mode against those of
  another run's stores (a card run's ``DIR/data`` beside a CPU run: what
  the card's round-off alone changes).

``--workers`` N > 1 (CPU only) sweeps both modes at once, each in N
processes of one thread, the ranks of a gloo group, each solving every
N-th chunk (``cli/sweep.py``'s chunk ownership).

Prints one JSON object and writes it to ``DIR/record_check.json``.  The
record was taken on a TPU (bf16 "default" matmul precision), so the check
is near-equality, not equality: round-off can flip a candidate's place in
an argsort, and with it a scenario's acceptance.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ..cli.sweep import run_sweep
from ..cli.validate import validate_compare
from .io_store import ResultStore

RECORD = Path(__file__).resolve().parents[2] / "artifacts" / "acceptance"
CELL = "gaussian_noise/noise_10/ts_50"
MODES = ("mmd_opt", "cvar")
# the sweep of each mode: ``run_sweep``'s arguments but the mode
SWEEP = dict(workload="static", noise="gaussian", noise_level=0.1, num_reduced=10,
             num_obs=6, num_prime=50, num_configs=200, chunk=8, dispatch="batch",
             scenario_chunk=8, inner_budget=None, outer_budget=None)
_FLAGS = dict(noise="noises", noise_level="noise_levels",
              num_reduced="num_reduced_sets")


def store_root(data: str, mode: str, sweep: dict = None) -> str:
    """A mode's store under ``data``, tagged with ``sweep``'s budgets as
    ``cli/sweep.py`` tags it (the record's stores: none)."""
    tag = mode
    for flag, budget in (("S", "inner_budget"), ("B", "outer_budget")):
        if sweep and sweep[budget]:
            tag += f"_{flag}{sweep[budget][0]}x{sweep[budget][1]}"
    return os.path.join(data, "static", CELL, f"{tag}_10_samples_6_obs")


def accepted_seeds(root: str) -> set:
    """The seeds of the scenarios a store holds."""
    return set(ResultStore(root).concatenated()["seeds"].tolist())


def _sweep_ranks(data: str, workers: int) -> None:
    """Both modes' sweeps on the CPU, ``workers`` one-thread ranks a mode."""
    procs = []
    for mode in MODES:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        args = [sys.executable, "-m", "mpc_mmd_tpu_torch.cli.sweep", "--costs", mode,
                "--out", data, "--device", "cpu", "--heartbeat_every", "1000000"]
        for k, v in SWEEP.items():
            if v is not None:
                args += [f"--{_FLAGS.get(k, k)}",
                         "x".join(map(str, v)) if isinstance(v, tuple) else str(v)]
        env = dict(os.environ, WORLD_SIZE=str(workers), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs += [subprocess.Popen(args, env=dict(env, RANK=str(r)),
                                   cwd=Path(__file__).resolve().parents[2])
                  for r in range(workers)]
    if any([p.wait() for p in procs]):
        raise RuntimeError("a rank of the CPU sweep failed")


def _band(fractions: np.ndarray, n_mc: int) -> float:
    """3 standard errors of the mean of per-scenario collision fractions,
    in percent."""
    p = np.asarray(fractions, np.float64)
    return 300.0 * float(np.sqrt(np.sum(p * (1.0 - p) / n_mc))) / len(p)


def record_check(out: str, device="cuda", n_mc: int = 1000, workers: int = 1,
                 beside: str = None) -> dict:
    out = os.path.abspath(out)
    data, rec_data = os.path.join(out, "data"), str(RECORD / "data_static")
    result = {"cell": f"static/{CELL}, N = 10, 6 obstacles, "
                      f"{SWEEP['num_configs']} configs", "device": device}
    t0 = time.perf_counter()
    if workers > 1:
        if device != "cpu":
            raise ValueError("--workers is for a sweep on the CPU")
        _sweep_ranks(data, workers)
        result["workers"] = workers
    else:
        for mode in MODES:
            run_sweep(mode=mode, out_root=data, device=device, **SWEEP)
    result["sweep_s"] = time.perf_counter() - t0
    roots = {m: store_root(data, m, SWEEP) for m in MODES}
    rec_roots = {m: store_root(rec_data, m) for m in MODES}
    with open(RECORD / "stats_static" / CELL / "10_samples_6_obs.json") as f:
        rec_stats = json.load(f)
    with np.load(RECORD / "stats_static" / CELL / "10_samples_6_obs.npz") as f:
        rec_coll = {m: f[f"coll_{m}"] for m in MODES}
    for mode in MODES:
        ours, theirs = accepted_seeds(roots[mode]), accepted_seeds(rec_roots[mode])
        result[mode] = {"accepted": len(ours), "record_accepted": len(theirs),
                        "both": len(ours & theirs), "only_port": len(ours - theirs),
                        "only_record": len(theirs - ours)}
        if beside:
            other = accepted_seeds(store_root(beside, mode, SWEEP))
            result[mode]["beside"] = {
                "accepted": len(other), "both": len(ours & other),
                "only_this": len(ours - other), "only_beside": len(other - ours),
                "record_among_only_this": len((ours - other) & theirs),
                "record_among_only_beside": len((other - ours) & theirs)}
    t0 = time.perf_counter()
    cmp = validate_compare([roots[m] for m in MODES], n_mc=n_mc,
                           out_root=os.path.join(out, "stats"), device=device)
    redo = validate_compare([rec_roots[m] for m in MODES], n_mc=n_mc,
                            out_root=os.path.join(out, "stats_record"), device=device)
    result["validate_s"] = time.perf_counter() - t0
    result["n_common"] = cmp["n_common"]
    result["record_n_common"] = rec_stats["n_common"]
    for mode in MODES:
        rec_pct = rec_stats["modes"][mode]["coll_pct_mean"]
        band = _band(rec_coll[mode] / rec_stats["n_mc"], rec_stats["n_mc"])
        port = cmp.get("modes", {}).get(mode, {}).get("coll_pct_mean")
        again = redo["modes"][mode]["coll_pct_mean"]
        result[mode].update(
            coll_pct=port, record_coll_pct=rec_pct, mc_band_pct=band,
            within_band=port is not None and abs(port - rec_pct) <= band,
            record_stores_validated_by_port_pct=again,
            record_stores_within_band=abs(again - rec_pct) <= band)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "record_check.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_mc", type=int, default=1000)
    p.add_argument("--workers", type=int, default=1,
                   help="CPU ranks a mode (the sweep on the CPU)")
    p.add_argument("--beside", default=None,
                   help="another run's DIR/data, to compare accepted scenarios")
    args = p.parse_args(argv)
    print(json.dumps(record_check(args.out, args.device, args.n_mc, args.workers,
                                  args.beside)))


if __name__ == "__main__":
    main()
