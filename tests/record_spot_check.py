"""Where the port's record check (``mpc_mmd_tpu_torch/utils/record_check.py``)
and the JAX record (``artifacts/acceptance/``, a TPU run) disagree, ask the
JAX package on the CPU.  Not a test: it runs full-width solves (about
20-50 s and 0.8 GB each), and it lives here because only tests import
both packages.

    JAX_PLATFORMS=cpu python tests/record_spot_check.py PORT_DATA

PORT_DATA is a record check's ``DIR/data``.  Prints JSON lines:

* the record's stores validated by the JAX package (into
  ``PORT_DATA/../stats_jax``): collision % and the rows whose counts
  equal the record's;
* for 3 scenarios of each mode that only the port accepted and 3 that
  only the record accepted, the JAX package's and the port's CPU solves
  of the same seed: their risk_obs and acceptance, beside the port run's
  and the record's.

    python tests/record_spot_check.py --port_seeds S [S ...] [--device cuda]

runs only the port (the card's machine has no JAX): the ``mmd_opt``
solves of those seeds' scenarios, each with its best cost per outer
iteration and risk_obs, to find where a card's solve leaves the CPU's.

    python tests/record_spot_check.py --port_seeds S [S ...] --dump DIR \
        [--device cuda] [--iterations 20]

dumps outer iterations 1-2 of each seed's solve stage by stage on the
card and on the CPU (``record_check.stage_dump``), and the outer loop's
own stages up to ``--iterations``, once on each side's own draws and once
on the CPU's draws replayed on both: one JSON line per seed and draws
(the first tensor apart, the first index apart, each side's cost trace
and the iteration where they part), the whole dump in
DIR/dump_<seed>_<draws>.json and its small tensors in .npz.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpc_mmd_tpu_torch.cli.sweep import accept_threshold, sweep_seeds  # noqa: E402
from mpc_mmd_tpu_torch.utils.io_store import ResultStore  # noqa: E402
from mpc_mmd_tpu_torch.utils.record_check import (  # noqa: E402
    CELL, MODES, RECORD, SWEEP, store_root)

N_SOLVES = 3


def _cell(mode: str) -> dict:
    return dict(num_reduced=SWEEP["num_reduced"], num_obs=SWEEP["num_obs"],
                noise=SWEEP["noise"], noise_level=SWEEP["noise_level"],
                num_prime=SWEEP["num_prime"], mode=mode)


def validate_record(out: str) -> None:
    import mpc_mmd_tpu.cli.validate as jv
    rec_data = str(RECORD / "data_static")
    res = jv.validate_compare([store_root(rec_data, m) for m in MODES],
                              n_mc=1000, seed=0, out_root=out)
    got = np.load(res["stats_path"])
    with np.load(RECORD / "stats_static" / CELL / "10_samples_6_obs.npz") as rec:
        for m in MODES:
            a, b = got[f"coll_{m}"], rec[f"coll_{m}"]
            print(json.dumps({"validate_record_stores": m, "coll_pct": res["modes"][m]["coll_pct_mean"],
                              "rows_equal_to_record": int((a == b).sum()),
                              "rows": len(a), "largest_count_gap": int(np.abs(a - b).max())}),
                  flush=True)


def resolve(port_data: str) -> None:
    from mpc_mmd_tpu import Solver, config as jc, scenarios as js
    from mpc_mmd_tpu_torch import Solver as PortSolver, static_workload
    seeds_all = sweep_seeds(SWEEP["num_configs"])
    for mode in MODES:
        port = ResultStore(store_root(port_data, mode)).concatenated()
        rec = ResultStore(store_root(str(RECORD / "data_static"), mode)).concatenated()
        ps, rs = set(port["seeds"].tolist()), set(rec["seeds"].tolist())
        cfg = jc.static_workload(**_cell(mode))
        thr = accept_threshold(mode, cfg.risk.ker_wt)
        batch = js.static_grid(cfg, SWEEP["num_configs"])
        init, mean, cov, v_des = js.ego_initial_state("static")
        solver = Solver(cfg)
        port_cpu = PortSolver(static_workload(**_cell(mode)), device="cpu")
        for which, seeds in (("only_port", sorted(ps - rs)[:N_SOLVES]),
                             ("only_record", sorted(rs - ps)[:N_SOLVES])):
            for seed in seeds:
                k = int(np.nonzero(seeds_all == seed)[0][0])
                t0 = time.perf_counter()
                risk = float(solver.solve(int(seed), init, mean, cov, batch.x_traj[k],
                                          batch.y_traj[k], v_des).risk_obs)
                risk_port = float(port_cpu.solve(
                    int(seed), *(np.asarray(a) for a in (init, mean, cov, batch.x_traj[k],
                                                         batch.y_traj[k])), v_des).risk_obs)
                at = lambda a: (float(a["risk_obs"][a["seeds"] == seed][0])
                                if seed in set(a["seeds"].tolist()) else None)
                print(json.dumps({"mode": mode, "accepted_by": which, "seed": int(seed),
                                  "config": k, "threshold": thr, "jax_cpu_risk_obs": risk,
                                  "jax_cpu_accepts": risk <= thr,
                                  "port_cpu_risk_obs": risk_port,
                                  "port_cpu_accepts": risk_port <= thr,
                                  "port_run_risk_obs": at(port),
                                  "record_tpu_risk_obs": at(rec),
                                  "s": round(time.perf_counter() - t0, 1)}), flush=True)


def port_solves(seeds, device: str) -> None:
    from mpc_mmd_tpu_torch import Solver, static_workload
    from mpc_mmd_tpu_torch.scenarios import ego_initial_state, static_grid
    seeds_all = sweep_seeds(SWEEP["num_configs"])
    cfg = static_workload(**_cell("mmd_opt"))
    batch = static_grid(cfg, SWEEP["num_configs"], device=device)
    init, mean, cov, v_des = ego_initial_state("static")
    solver = Solver(cfg, device=device)
    for seed in seeds:
        k = int(np.nonzero(seeds_all == seed)[0][0])
        r = solver.solve(int(seed), init, mean, cov, batch.x_traj[k], batch.y_traj[k],
                         v_des)
        print(json.dumps({"mode": "mmd_opt", "seed": int(seed), "device": device,
                          "risk_obs": float(r.risk_obs),
                          "res": [float(x) for x in r.res.cpu()],
                          "res_beta": [float(x) for x in r.res_beta.cpu()]}), flush=True)


def dump_seeds(seeds, device: str, out: str, iterations: int) -> None:
    from mpc_mmd_tpu_torch.utils.record_check import stage_dump
    Path(out).mkdir(parents=True, exist_ok=True)
    for seed in seeds:
        for draws in ("own", "cpu"):
            t0 = time.perf_counter()
            d = stage_dump(seed, (device, "cpu"), draws, iterations,
                           npz=str(Path(out) / f"dump_{seed}_{draws}.npz"))
            with open(Path(out) / f"dump_{seed}_{draws}.json", "w") as f:
                json.dump(d, f)
            print(json.dumps({k: v for k, v in d.items() if k != "stages"}
                             | {"stages": len(d["stages"]),
                                "s": round(time.perf_counter() - t0, 1)}), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("port_data", nargs="?")
    p.add_argument("--port_seeds", type=int, nargs="*")
    p.add_argument("--device", default="cpu")
    p.add_argument("--dump", default=None)
    p.add_argument("--iterations", type=int, default=20)
    args = p.parse_args()
    if args.port_seeds and args.dump:
        dump_seeds(args.port_seeds, args.device, args.dump, args.iterations)
        return
    if args.port_seeds:
        port_solves(args.port_seeds, args.device)
        return
    validate_record(str(Path(args.port_data).parent / "stats_jax"))
    resolve(args.port_data)


if __name__ == "__main__":
    main()
