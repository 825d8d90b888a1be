"""Monte-Carlo validation of a sweep's accepted solves.

Counterpart of ``mpc_mmd_tpu/cli/validate.py``: reads a ResultStore
written by either package's sweep, re-rolls n_mc noisy rollouts per solve
on the device (K4 on a card), and writes the same statistics files.

``validate_compare`` is the reference's config-intersection step
(validation.py:284-304): the (init_state || x_obs || y_obs || vx_obs ||
vy_obs) row of each accepted solve is the scenario key, keys are
intersected across all modes, and only the common scenarios are validated,
each mode with the same seed, so row i of every mode meets the same draws.
Stats land in the reference's layout
``stats/{noise}_noise/noise_{lvl}/ts_{np}/{N}_samples_{M}_obs.npz`` with
``coll_{mode}`` / ``coll_{mode}_lane`` / ``idx_{mode}`` arrays and a JSON
sidecar, which cli/report.py's grid box plot reads.

Usage:
    python -m mpc_mmd_tpu_torch.cli.validate --data ./data/static/... --n_mc 1000
    python -m mpc_mmd_tpu_torch.cli.validate --compare --data \\
        ./data/static/.../mmd_opt_* ./data/static/.../cvar_* --n_mc 1000 \\
        --out ./stats --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import resolve_device
from ..config import dynamic_workload, static_workload
from ..qp import build_workspace
from ..utils.io_store import ResultStore
from ..validate import make_validator


def config_of(meta: dict):
    """The ProblemConfig a store's meta describes, as far as the validator
    reads it (noise, horizon, obstacles, lane)."""
    make = static_workload if meta.get("workload", "static") == "static" \
        else dynamic_workload
    return make(num_reduced=meta["num_reduced"], num_obs=meta["num_obs"],
                noise=meta["noise"], noise_level=meta["noise_level"],
                num_prime=meta["num_prime"], mode=meta["mode"])


def _refuse_mesh(mesh: bool) -> None:
    if mesh:
        raise NotImplementedError("the mesh-sharded validator is not ported "
                                  "(ROADMAP.md Queue 1, 'Distribution and "
                                  "operations')")


def _validate(meta, arrays, idx, n_mc, seed, dev, noise):
    """(coll_count, lane_count, coll_fraction) as numpy, one fetch each."""
    cfg = config_of(meta)
    validator = make_validator(cfg, build_workspace(cfg, dev), n_mc=n_mc,
                               noise=noise)
    stats = validator(arrays["cx"][idx], arrays["cy"][idx],
                      arrays["init_state"][0], arrays["x_obs_traj"][idx],
                      arrays["y_obs_traj"][idx], seed)
    return tuple(t.cpu().numpy() for t in stats)


def validate_store(data_root: str, n_mc: int = 1000, seed: int = 0,
                   out_root: str | None = None, mesh: bool = False,
                   device="cuda", noise=None) -> dict:
    """Validate every solve of one store; writes ``validation.npz`` and
    ``summary.json`` under ``out_root`` (default: the store's path with
    /data/ replaced by /stats/, else ``<store>/stats``).  ``noise``
    defaults to TorchNoise on the device."""
    _refuse_mesh(mesh)
    dev = resolve_device(device)
    store = ResultStore(data_root)
    arrays = store.concatenated()
    if len(arrays.get("cx", ())) == 0:
        return {"n_solves": 0}
    coll, lane, frac = _validate(store.meta, arrays, slice(None), n_mc, seed,
                                 dev, noise)
    out = {
        "n_solves": int(len(coll)),
        "n_mc": n_mc,
        "coll_count": coll.tolist(),
        "lane_count": lane.tolist(),
        "coll_fraction": frac.tolist(),
        "coll_pct_mean": float(np.mean(coll) / n_mc * 100.0),
        "coll_pct_p50": float(np.percentile(coll, 50) / n_mc * 100.0),
        "coll_pct_p95": float(np.percentile(coll, 95) / n_mc * 100.0),
    }
    out_root = out_root or data_root.replace("/data/", "/stats/")
    if out_root == data_root:
        out_root = os.path.join(data_root, "stats")
    os.makedirs(out_root, exist_ok=True)
    np.savez(os.path.join(out_root, "validation.npz"),
             coll_count=coll, lane_count=lane, coll_fraction=frac,
             n_mc=np.int64(n_mc),
             seeds=arrays.get("seeds", np.zeros(0)))
    with open(os.path.join(out_root, "summary.json"), "w") as f:
        json.dump({k: v for k, v in out.items()
                   if not isinstance(v, list)}, f, indent=1)
    return out


def scenario_keys(arrays: dict, num_obs: int) -> list:
    """Per-solve scenario key rows (validation.py:284-295): hstack of
    init_state and the obstacle config, hashed as float tuples."""
    mat = np.hstack([
        np.asarray(arrays["init_state"], np.float64),
        np.asarray(arrays["x_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["y_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["vx_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["vy_obs"], np.float64)[:, :num_obs],
    ])
    return [tuple(row) for row in mat]


def intersect_stores(all_arrays: list, num_obs: int) -> list:
    """Row indices per store covering exactly the scenarios accepted by
    every store (set intersection, sorted keys, first occurrence wins on
    duplicates; validation.py:296-325).  Row i of each output refers to the
    same scenario."""
    key_lists = [scenario_keys(a, num_obs) for a in all_arrays]
    common = set(key_lists[0])
    for keys in key_lists[1:]:
        common &= set(keys)
    common = sorted(common)
    out = []
    for keys in key_lists:
        first = {}
        for i, k in enumerate(keys):
            first.setdefault(k, i)
        out.append(np.asarray([first[k] for k in common], np.int64))
    return out


def paired_stats(a: np.ndarray, b: np.ndarray, n_boot: int = 10000,
                 seed: int = 0) -> dict:
    """Paired significance of collision counts ``a`` vs ``b`` over the same
    scenarios: the two-sided Wilcoxon signed-rank p-value (zero differences
    split; 1.0 when every pair ties) and a seeded percentile-bootstrap 95%
    CI on mean(a - b).  mean_diff < 0 with the CI excluding 0 means ``a``
    beats ``b``."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"paired arrays must match: {a.shape} vs {b.shape}")
    d = a - b
    out = {"n": int(len(d)), "mean_diff": float(np.mean(d)),
           "p50_diff": float(np.median(d))}
    try:
        from scipy.stats import wilcoxon
        if np.all(d == 0):
            out["p_wilcoxon"] = 1.0
        else:
            out["p_wilcoxon"] = float(
                wilcoxon(a, b, zero_method="zsplit",
                         alternative="two-sided").pvalue)
    except ImportError:                      # pragma: no cover
        out["p_wilcoxon"] = None
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(d), size=(n_boot, len(d)))
    boot_means = np.mean(d[idx], axis=1)
    lo, hi = np.percentile(boot_means, [2.5, 97.5])
    out["mean_diff_ci95"] = [float(lo), float(hi)]
    out["significant_05"] = bool(out["p_wilcoxon"] is not None
                                 and out["p_wilcoxon"] < 0.05)
    return out


def validate_compare(data_roots: list, n_mc: int = 1000, seed: int = 0,
                     out_root: str = "./stats", mesh: bool = False,
                     labels: list | None = None, device="cuda",
                     noise=None) -> dict:
    """Joint validation of one scenario config swept under several modes.

    All stores must share (workload, noise, noise_level, num_reduced,
    num_obs, num_prime).  ``labels`` name each store's arrays (default:
    its mode; required when two stores share a mode).  Writes the stats npz
    and its JSON sidecar; refuses to overwrite stats of another workload.
    """
    _refuse_mesh(mesh)
    dev = resolve_device(device)
    stores = [ResultStore(r) for r in data_roots]
    metas = [s.meta for s in stores]
    base = metas[0]
    for m in metas[1:]:
        for k in ("workload", "noise", "noise_level", "num_reduced",
                  "num_obs", "num_prime"):
            if m.get(k) != base.get(k):
                raise ValueError(f"store mismatch on {k}: "
                                 f"{m.get(k)} != {base.get(k)}")
    if labels is None:
        labels = [m["mode"] for m in metas]
    if len(labels) != len(stores):
        raise ValueError(f"{len(labels)} labels for {len(stores)} stores")
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate labels {labels}; pass explicit "
                         "--labels to disambiguate same-mode stores")
    num_obs = base["num_obs"]
    all_arrays = [s.concatenated() for s in stores]
    if any(len(a.get("cx", ())) == 0 for a in all_arrays):
        return {"n_common": 0}
    joins = intersect_stores(all_arrays, num_obs)
    n_common = len(joins[0])
    if n_common == 0:
        return {"n_common": 0}

    out = {"n_common": int(n_common), "n_mc": n_mc, "modes": {}}
    npz_payload = {}
    for mode, meta, arrays, idx in zip(labels, metas, all_arrays, joins):
        coll, lane, _ = _validate(meta, arrays, idx, n_mc, seed, dev, noise)
        npz_payload[f"coll_{mode}"] = coll
        npz_payload[f"coll_{mode}_lane"] = lane
        # store row of each joined scenario, for reports that map a paired
        # row back to the solve
        npz_payload[f"idx_{mode}"] = idx
        out["modes"][mode] = {
            "coll_pct_mean": float(np.mean(coll) / n_mc * 100.0),
            "coll_pct_p50": float(np.percentile(coll, 50) / n_mc * 100.0),
            "coll_pct_p95": float(np.percentile(coll, 95) / n_mc * 100.0),
            "lane_mean": float(np.mean(lane)),
        }

    out["pairs"] = {}
    for i in range(len(labels)):
        for j in range(i + 1, len(labels)):
            mi, mj = labels[i], labels[j]
            out["pairs"][f"{mi}_vs_{mj}"] = paired_stats(
                npz_payload[f"coll_{mi}"], npz_payload[f"coll_{mj}"],
                seed=seed)

    stats_dir = os.path.join(
        out_root, f"{base['noise']}_noise",
        f"noise_{round(base['noise_level'] * 100)}",
        f"ts_{base['num_prime']}")
    os.makedirs(stats_dir, exist_ok=True)
    stats_path = os.path.join(
        stats_dir, f"{base['num_reduced']}_samples_{num_obs}_obs.npz")
    # the layout does not encode the workload: refuse to let static and
    # dynamic runs with the same knobs overwrite each other
    workload = base.get("workload", "static")
    sidecar = stats_path.replace(".npz", ".json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            prev = json.load(f)
        if prev.get("workload", workload) != workload:
            raise ValueError(
                f"{stats_path} already holds {prev['workload']!r} stats; "
                f"pass a different --out root for the {workload!r} workload")
    out["workload"] = workload
    npz_payload["n_mc"] = np.int64(n_mc)
    np.savez(stats_path, **npz_payload)
    out["stats_path"] = stats_path
    with open(sidecar, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=str, nargs="+", required=True)
    p.add_argument("--compare", action="store_true",
                   help="intersect scenarios across the given stores and "
                        "write paired stats (reference validation.py:284)")
    p.add_argument("--n_mc", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--mesh", action="store_true",
                   help="mesh-sharded validation: not ported")
    p.add_argument("--labels", type=str, nargs="+", default=None,
                   help="per-store array labels for --compare (default: "
                        "each store's mode; required when stores share one)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    args = p.parse_args(argv)
    if args.compare:
        out = validate_compare(args.data, args.n_mc, args.seed,
                               args.out or "./stats", mesh=args.mesh,
                               labels=args.labels, device=args.device)
        print(json.dumps(out, indent=1))
    else:
        for root in args.data:
            out = validate_store(root, args.n_mc, args.seed, args.out,
                                 mesh=args.mesh, device=args.device)
            print(json.dumps({k: v for k, v in out.items()
                              if not isinstance(v, list)}, indent=1))


if __name__ == "__main__":
    main()
