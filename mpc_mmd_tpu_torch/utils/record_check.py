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
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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


# The stages of an outer iteration in ``solver.py``'s order, each a name
# that ``solver.py`` (or ``reduced_set.py``, ``ops/inner_cem.py``,
# ``risk.py``) calls through its module, or a method of the noise sources
# ("module:Class"): the solve's Gaussian draws (every iteration's, drawn
# before the loop and recorded as iteration 0's), the guess QP, the
# projection, the controls, the noisy controls, the K4 rollouts, the
# refit, the inner CEM (the top-k selections and elite picks, the K2
# weight QPs; a selection's input is the resample of the iteration
# before), the risks, the scalar cost, the outer CEM's update; and the
# argsorts and argmins of the solver
# and of ``sampling.cem_tail``.  Stages in ``_INPUTS`` record their
# arguments too.  While the taps are in, the "xla" selection's inner CEM,
# the outer iteration and the steps around the rollouts run their plain
# chains on every device (``inner_cem_plain``, K1 and K2 on the card;
# ``outer_project_plain``, ``outer_tail_plain``; no glue route of
# ``SolverSetup._glue_routes``: noisy_controls and K4, the refit):
# kernels (c) to (f) and K4n would run those stages inside one launch
# each, where no tap sees them.
_STAGES = (("solver", ("initial_params", "noisy_controls", "batched_rollouts",
                       "refit_coefficients", "select_reduced")),
           ("qp", ("compute_guess",)),
           ("projection", ("project",)),
           ("dynamics", ("controls_from_trajectory",)),
           ("sampling", ("scalar_cost", "cem_update")),
           ("noise:JaxNoise", ("solve_draws",)),
           ("noise:FixedNoise", ("solve_draws",)),
           ("ops.inner_cem", ("topk_indices", "eq_qp_solve")),
           ("risk", ("mmd_obs", "mmd_lane")))
_INPUTS = ("eq_qp_solve", "topk_indices")


def _flat(name: str, value, out: list) -> None:
    """The tensors of a stage's value (nested tuples, NamedTuples, dicts)
    as (name, CPU tensor) pairs."""
    if torch.is_tensor(value):
        out.append((name, value.detach().cpu()))
    elif isinstance(value, dict):
        for k, v in value.items():
            _flat(f"{name}.{k}", v, out)
    elif isinstance(value, tuple):
        fields = getattr(value, "_fields", range(len(value)))
        for k, v in zip(fields, value):
            _flat(f"{name}.{k}", v, out)


# the stages recorded past the detailed iterations: the outer loop's own
_OUTER = ("project", "argsort", "argmin", "mmd_obs", "mmd_lane", "scalar_cost",
          "cem_update")


class _Tap:
    """Records the stages' outputs, keyed "it<i> <stage>#<call>.<field>"
    with i the outer iteration (1-based), while installed: every stage in
    iterations 1 ... ``detail``, the outer loop's own (``_OUTER``) after."""

    def __init__(self, detail: int):
        self.records, self.it, self.calls = [], 0, {}
        self.detail = detail
        self._undo = []

    def record(self, stage: str, value, prefix: str = "", n: int = None):
        """Records ``value`` under this call of ``stage`` (or call ``n``);
        returns the call's number, None if not recorded."""
        if stage == "compute_guess" and n is None:
            self.it += 1
        if self.it > self.detail and stage not in _OUTER:
            return None
        key = f"it{self.it} {stage}"
        if n is None:
            n = self.calls[key] = self.calls.get(key, 0) + 1
        _flat(f"{key}#{n}{prefix}", value, self.records)
        return n

    def wrap(self, stage: str, fn):
        def tapped(*args, **kw):
            out = fn(*args, **kw)
            n = self.record(stage, out)
            if n is not None and stage in _INPUTS:
                self.record(stage, args, ".in", n)
            return out
        return tapped

    def patch(self, obj, name: str, fn) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, fn)

    def __enter__(self):
        import importlib
        for where, names in _STAGES:
            mod, _, cls = where.partition(":")
            m = importlib.import_module(f"mpc_mmd_tpu_torch.{mod}")
            m = getattr(m, cls) if cls else m
            for name in names:
                self.patch(m, name, self.wrap(name, getattr(m, name)))
        tap = self

        class _Torch:
            """``torch`` for solver.py, its argsorts and argmins recorded."""

            def __getattr__(self, name):
                return getattr(torch, name)

            def argsort(self, *a, **kw):
                out = torch.argsort(*a, **kw)
                tap.record("argsort", out)
                return out

            def argmin(self, *a, **kw):
                out = torch.argmin(*a, **kw)
                tap.record("argmin", out)
                return out

        from .. import reduced_set, sampling, solver
        self.patch(solver, "torch", _Torch())
        self.patch(sampling, "torch", _Torch())
        plain = lambda mod, name: getattr(
            importlib.import_module(f"mpc_mmd_tpu_torch.ops.{mod}"), f"{name}_plain")
        self.patch(reduced_set, "inner_cem", plain("inner_cem", "inner_cem"))
        self.patch(solver, "outer_project", plain("outer_project", "outer_project"))
        self.patch(solver, "outer_tail", plain("outer_tail", "outer_tail"))
        self.patch(solver.SolverSetup, "_glue_routes",
                   lambda _self: solver.GlueRoutes(False, False, False))
        return self

    def __exit__(self, *exc):
        for obj, name, fn in reversed(self._undo):
            setattr(obj, name, fn)


def _compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    """How far tensor a lies from b: for indices, how many differ; for
    floats, the largest gap, the scale max(1, max |b|) and how many
    elements lie more than 1e-6 of the scale apart (NaN equal to NaN, a
    NaN against a number infinitely apart), with the worst element."""
    if a.shape != b.shape:
        return {"shape": [list(a.shape), list(b.shape)], "gap": math.inf}
    if not a.is_floating_point():
        diff = (a != b).reshape(-1)
        n = int(diff.sum())
        at = int(diff.nonzero()[0]) if n else None
        return {"shape": list(a.shape), "index": True, "n_apart": n,
                "first": None if at is None else
                [at, int(a.reshape(-1)[at]), int(b.reshape(-1)[at])]}
    a64, b64 = a.double().reshape(-1), b.double().reshape(-1)
    same = (a64 == b64) | (a64.isnan() & b64.isnan())
    gap = lambda x, y: torch.where((x == y) | (x.isnan() & y.isnan()), 0.0,
                                   (x - y).abs().nan_to_num(math.inf))
    d = gap(a64, b64)
    finite = b64[b64.isfinite()]
    scale = max(1.0, float(finite.abs().max()) if len(finite) else 1.0)
    at = int(d.argmax()) if len(d) else 0
    return {"shape": list(a.shape), "gap": float(d.max()) if len(d) else 0.0,
            "scale": scale, "n_apart": int((d > 1e-6 * scale).sum()),
            "n_differ": int((~same).sum()),
            # the gap of the sorted values: round-off after a reordering
            # of the same candidates stays small, another pick does not
            "gap_sorted": float(gap(a64.sort().values, b64.sort().values).max())
            if len(d) else 0.0,
            "worst": [at, float(a64[at]), float(b64[at])] if len(d) else None}


# the axis along which a stage's tensors hold an outer iteration's
# candidates, in the order of its first argsort (the projection residual);
# the refit's rows are the candidates' mother rollouts, candidate-major
_CANDIDATE_AXIS = {"noisy_controls": 1,
                   "batched_rollouts": 1, "refit_coefficients": 0, "topk_indices": 0,
                   "eq_qp_solve": 0, "select_reduced": 1, "mmd_obs": 1}


def _by_candidate(records: list, nb: int) -> list:
    """The records with each iteration's candidates put back in the
    projection's order (undoing the residual sort, whose near-ties order
    them differently on two devices) and its second argsort (by risk)
    given as the candidates it ranks, so that two devices' records compare
    candidate by candidate."""
    out, perm = [], None
    for key, t in records:
        it, rest = key.split(" ", 1) if " " in key else ("", key)
        stage = rest.split("#")[0]
        if rest.startswith("argsort#1"):
            perm = t.reshape(-1)
        elif rest.startswith("argsort#2") and perm is not None:
            t = perm[t]
        elif stage in _CANDIDATE_AXIS and perm is not None:
            ax = _CANDIDATE_AXIS[stage]
            inv = torch.argsort(perm)
            if t.dim() > ax and t.shape[ax] == nb:
                t = t.index_select(ax, inv)
            elif stage == "refit_coefficients" and t.shape[0] % nb == 0:
                t = t.view(nb, -1, *t.shape[1:]).index_select(0, inv).reshape(t.shape)
        out.append((key, t))
        if rest.startswith("cem_update"):
            perm = None
    return out


def stage_dump(seed: int, devices=("cuda", "cpu"), draws: str = "own",
               iterations: int = 2, cfg=None, npz: str = None) -> dict:
    """Outer iterations 1 ... ``iterations`` of the record cell's
    ``mmd_opt`` solve of scenario ``seed``, stage by stage on each of
    ``devices``, the first held against the second.

    ``draws`` "own": each device on its own default draws (``JaxNoise``:
    the kernels on the card, their twins on the CPU); "cpu": every device
    on the CPU's draws, replayed through ``FixedNoise``, so that what
    differs is the computation's round-off alone.  ``cfg`` replaces the
    record cell's configuration (a smaller one, for a rehearsal).  Every
    stage is recorded in iterations 1 and 2, the outer loop's own after
    them; ``npz`` names a file for the recorded tensors of up to
    2,000 elements of both devices ("<device>/<stage>"), and its
    "_first_index" twin for the first index tensor apart and its inputs.
    Returns, per stage in the order the solve reached it, the gap of the
    first device's tensor to the second's (``_compare``; each iteration's
    candidates put in the projection's order on both, ``_by_candidate``),
    the first float tensor more than 1e-6 of its scale apart, the first
    index tensor (an argsort, a top-k) that differs beyond the residual
    order, the iteration whose best cost parts, and each device's best
    cost per iteration.
    """
    import dataclasses
    from ..cli.sweep import sweep_seeds
    from ..noise import FixedNoise, JaxNoise, record_solve_draws
    from ..scenarios import ego_initial_state, static_grid
    from ..solver import Solver
    from ..config import static_workload
    cell = {k: SWEEP[k] for k in ("num_reduced", "num_obs", "noise", "noise_level",
                                  "num_prime")}
    cfg = cfg or static_workload(**cell, mode="mmd_opt")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=iterations))
    k = int(np.nonzero(sweep_seeds(SWEEP["num_configs"]) == seed)[0][0])
    batch = static_grid(cfg, SWEEP["num_configs"], device="cpu")
    init, mean, cov, v_des = ego_initial_state("static")
    fixed = (record_solve_draws(JaxNoise("cpu"), cfg, seed)[0] if draws == "cpu"
             else None)
    runs = []
    for dev in devices:
        noise = FixedNoise(fixed, dev) if fixed is not None else JaxNoise(dev)
        solver = Solver(cfg, device=dev, noise=noise, graph=False)
        with _Tap(2) as tap:
            r = solver.solve(seed, init, mean, cov, batch.x_traj[k], batch.y_traj[k],
                             v_des)
        draws_used = []
        _flat("draws", (solver._z0, solver._inner), draws_used)
        runs.append((draws_used + tap.records, [float(x) for x in r.res.cpu()],
                     float(r.risk_obs)))
    if npz:
        np.savez_compressed(npz, **{f"{dev}/{key}": t.numpy()
                                    for dev, (records, _, _) in zip(devices, runs)
                                    for key, t in records if t.numel() <= 2000})
    (mine, res_a, risk_a), (theirs, res_b, risk_b) = runs
    departs = next((i + 1 for i, (x, y) in enumerate(zip(res_a, res_b))
                    if abs(x - y) > 1e-6 * max(1.0, abs(y))), None)
    nb = cfg.cem.num_batch
    mine, theirs = _by_candidate(mine, nb), _by_candidate(theirs, nb)
    ref = dict(theirs)
    stages, first_float, first_index = [], None, None
    for key, a in mine:
        if key not in ref:
            stages.append({"stage": key, "missing_on": devices[1]})
            continue
        c = dict(_compare(a, ref[key]), stage=key)
        stages.append(c)
        # the residual order is compared, not counted: its near-ties are
        # undone candidate by candidate after it
        if (first_index is None and c.get("index") and c["n_apart"]
                and "argsort#1" not in key):
            first_index = c
            if npz:
                inputs = [k for k, _ in mine if k.startswith(key + ".in.")]
                np.savez_compressed(npz.replace(".npz", "_first_index.npz"), **{
                    f"{dev}/{k}": t.numpy() for dev, recs in zip(devices, (mine, theirs))
                    for k, t in recs if k == key or k in inputs})
        if first_float is None and not c.get("index") and c.get("n_apart", 1):
            first_float = c
    return {"seed": seed, "config": k, "devices": list(devices), "draws": draws,
            "iterations": iterations, "res_departs_at": departs,
            "first_float_apart": first_float,
            "first_index_apart": first_index,
            "res": {devices[0]: res_a, devices[1]: res_b},
            "risk_obs": {devices[0]: risk_a, devices[1]: risk_b},
            "stages": stages}


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
