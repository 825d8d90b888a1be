"""Batch solve sweep over obstacle scenarios (static or dynamic workloads).

Counterpart of ``mpc_mmd_tpu/cli/sweep.py``, with its flags, store tags
and meta, so both packages write the same stores.  Scenarios solve chunk
by chunk; accepted solves (risk below the mode's threshold, the
reference's main_mpc.py:86-97) are kept on the host, and chunks land in a
resumable ResultStore.

Usage:
    python -m mpc_mmd_tpu_torch.cli.sweep --workload static --costs mmd_opt cvar \
        --noise_levels 0.1 --num_reduced_sets 10 --num_obs 6 --num_prime 50 \
        --noises gaussian --num_configs 200 --out ./data --device cuda

Over several ranks (each rank solves the chunks it owns, chunk id modulo
the world size, and writes its own store shard; ``--dispatch mesh`` or
``--heartbeat_every`` joins the group torchrun describes):
    torchrun --nproc_per_node 2 -m mpc_mmd_tpu_torch.cli.sweep ... \
        --dispatch mesh --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from . import resolve_device
from ..config import dynamic_workload, static_workload
from ..scenarios import dynamic_cutin, ego_initial_state, static_grid
from ..parallel.mesh import initialize_distributed, make_mesh
from ..solver import Solver, SolveResult
from ..utils.debug import hosts_alive
from ..utils.io_store import ResultStore
from ..utils.observability import MetricLogger, device_trace, phase_timer

DISPATCHES = ("pipeline", "batch", "mesh")


class HostFailure(RuntimeError):
    """A peer rank failed the heartbeat; completed chunks are already
    persisted, so re-running the sweep resumes from the failure point."""


def _rank_world():
    """(rank, world size) of the initialized group, else (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def accept_threshold(mode: str, ker_wt: float) -> float:
    """Ref: main_mpc.py:86-97."""
    if mode.startswith("mmd"):
        return -ker_wt + 1.0
    return 1.0e-5


def sweep_seeds(num_configs: int) -> np.ndarray:
    """The seed of each config's solve (the JAX CLI's rule)."""
    return np.random.RandomState(0).randint(1, 10000, size=num_configs)


def run_sweep(workload: str, mode: str, noise: str, noise_level: float,
              num_reduced: int, num_obs: int, num_prime: int,
              num_configs: int, out_root: str, chunk: int = 20,
              acc_const_noise: float = 0.0, steer_const_noise: float = 0.0,
              logger: MetricLogger | None = None,
              heartbeat_every: int = 0,
              heartbeat_timeout_s: float = 30.0,
              dispatch: str | None = None,
              inner_budget: tuple | None = None,
              outer_budget: tuple | None = None,
              accept_all: bool = False,
              kernel: str = "laplace",
              scenario_chunk: int | None = None,
              device="cuda") -> ResultStore:
    """One sweep into ``{out_root}/{tag}``; arguments as the JAX package's.

    ``dispatch`` (default "pipeline"): "pipeline" enqueues one
    ``Solver.solve`` per scenario of a chunk and stacks the results on the
    device; "batch" runs the chunk through
    ``Solver.solve_batch``, ``scenario_chunk`` scenarios per outer loop;
    "mesh" does what "batch" does on this rank's device and logs each
    chunk's accepted count as ``chunk_psum_stats``, the JAX CLI's record
    (a chunk is one rank's alone, so no collective sums it).  Either way
    the chunk's cx, cy and risk_obs are fetched once.  Under an
    initialized group of several ranks, whatever the dispatch, each rank
    solves only the chunks it owns (chunk id modulo the world size) and
    writes them to its own store shard.

    ``heartbeat_every`` N > 0: before every N-th chunk, owned or not, every
    rank probes ``hosts_alive(heartbeat_timeout_s)`` (a collective, so all
    ranks probe at the same chunks) and raises :class:`HostFailure` if a
    peer is gone; the finished chunks are on disk, and a rerun resumes.
    """
    dispatch = dispatch or "pipeline"
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    dev = resolve_device(device)
    logger = logger or MetricLogger()
    make = static_workload if workload == "static" else dynamic_workload
    cfg = make(num_reduced=num_reduced, num_obs=num_obs, noise=noise,
               noise_level=noise_level, num_prime=num_prime, mode=mode,
               acc_const_noise=acc_const_noise,
               steer_const_noise=steer_const_noise)
    if inner_budget is not None:
        S_b, it_b = inner_budget
        cfg = cfg.replace(beta_cem=dataclasses.replace(
            cfg.beta_cem, num_samples_cem=S_b, maxiter=it_b))
    if outer_budget is not None:
        B_b, it_b = outer_budget
        cfg = cfg.replace(cem=dataclasses.replace(
            cfg.cem, num_batch=B_b, maxiter_cem=it_b))
    if kernel != "laplace":
        cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kernel))
    process_id, num_processes = _rank_world()
    if dispatch == "mesh":
        # each rank runs its own chunks apart from the others: its mesh is
        # itself, so no collective waits on a rank on another chunk
        dev = make_mesh(local=True, device=dev).device
    solver = Solver(cfg, device=dev, scenario_chunk=scenario_chunk)

    with phase_timer(logger, "scenario_gen"):
        if workload == "static":
            batch = static_grid(cfg, num_configs, device=dev)
        else:
            batch = dynamic_cutin(cfg, num_configs, device=dev)

    init_state, mean, cov, v_des = ego_initial_state(workload)
    # accept_all persists every solve with its risk_obs, so any acceptance
    # rule can be re-derived downstream
    threshold = np.inf if accept_all else \
        accept_threshold(mode, cfg.risk.ker_wt)

    # round(), not int(): 0.29 * 100 == 28.999..., and the stats layout of
    # cli/validate.py rounds too
    mode_tag = mode if inner_budget is None else \
        f"{mode}_S{inner_budget[0]}x{inner_budget[1]}"
    if outer_budget is not None:
        mode_tag += f"_B{outer_budget[0]}x{outer_budget[1]}"
    if kernel != "laplace":
        mode_tag += f"_K{kernel}"
    if accept_all:
        mode_tag += "_all"
    tag = (f"{workload}/{noise}_noise/noise_{round(noise_level * 100)}/"
           f"ts_{num_prime}/{mode_tag}_{num_reduced}_samples_{num_obs}_obs")
    meta = {
        "workload": workload, "mode": mode, "noise": noise,
        "noise_level": noise_level, "num_reduced": num_reduced,
        "num_obs": num_obs, "num_prime": num_prime,
        "num_configs": num_configs}
    if inner_budget is not None:
        meta["inner_budget"] = list(inner_budget)
    if outer_budget is not None:
        meta["outer_budget"] = list(outer_budget)
    if accept_all:
        meta["accept_all"] = True
    if kernel != "laplace":
        meta["kernel"] = kernel
    store = ResultStore(f"{out_root}/{tag}", meta=meta,
                        process_id=process_id, num_processes=num_processes)

    seeds_all = sweep_seeds(num_configs)

    # the scenario fields on the host once; the solve's inputs on the device
    # once (a pageable host-to-device copy per solve would sync each one)
    host = {f: getattr(batch, f).cpu().numpy()
            for f in ("x_obs", "y_obs", "vx_obs", "vy_obs", "psi_obs",
                      "x_traj", "y_traj")}
    init_t, mean_t, cov_t = (torch.as_tensor(a, device=dev)
                             for a in (init_state, mean, cov))

    n_chunks = (num_configs + chunk - 1) // chunk
    for cid in range(n_chunks):
        if heartbeat_every and cid % heartbeat_every == 0:
            if not hosts_alive(heartbeat_timeout_s):
                logger.log("host_failure", chunk=cid)
                raise HostFailure(
                    f"heartbeat failed before chunk {cid}; "
                    f"{len(store.done_chunks())} chunks persisted — rerun to "
                    "resume")
        if not store.owns(cid) or store.is_done(cid):
            continue
        lo, hi = cid * chunk, min((cid + 1) * chunk, num_configs)
        sl = slice(lo, hi)
        with phase_timer(logger, "solve_chunk", chunk=cid, size=hi - lo):
            if dispatch == "pipeline":
                outs = [solver.solve(int(seeds_all[i]), init_t, mean_t, cov_t,
                                     batch.x_traj[i], batch.y_traj[i], v_des)
                        for i in range(lo, hi)]
                out = SolveResult(*(torch.stack(f) for f in zip(*outs)))
            else:
                out = solver.solve_batch(seeds_all[sl], init_t, mean_t, cov_t,
                                         batch.x_traj[sl], batch.y_traj[sl], v_des)
            # one fetch of the chunk: cx | cy | risk_obs side by side
            packed = torch.cat((out.cx, out.cy, out.risk_obs[:, None]),
                               dim=1).cpu().numpy()
        nvar = cfg.horizon.nvar
        cx_np, cy_np = packed[:, :nvar], packed[:, nvar:2 * nvar]
        risk = packed[:, 2 * nvar]
        keep = risk <= threshold
        if dispatch == "mesh":
            logger.log("chunk_psum_stats", chunk=cid, accepted=int(keep.sum()))
        store.write_chunk(
            cid,
            cx=cx_np[keep], cy=cy_np[keep],
            init_state=np.tile(init_state, (int(keep.sum()), 1)),
            x_obs=host["x_obs"][sl][keep],
            y_obs=host["y_obs"][sl][keep],
            vx_obs=host["vx_obs"][sl][keep],
            vy_obs=host["vy_obs"][sl][keep],
            psi_obs=host["psi_obs"][sl][keep],
            x_obs_traj=host["x_traj"][sl][keep],
            y_obs_traj=host["y_traj"][sl][keep],
            risk_obs=risk[keep],
            seeds=seeds_all[sl][keep],
        )
        logger.log("chunk_done", chunk=cid, accepted=int(keep.sum()),
                   total=hi - lo)
    if dist.is_initialized():
        dist.barrier()          # every rank's shard is on disk before any reads
    return store


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", choices=["static", "dynamic"], default="static")
    p.add_argument("--costs", type=str, nargs="+", required=True)
    p.add_argument("--noise_levels", type=float, nargs="+", required=True)
    p.add_argument("--num_reduced_sets", type=int, nargs="+", required=True)
    p.add_argument("--num_obs", type=int, nargs="+", required=True)
    p.add_argument("--num_prime", type=int, nargs="+", required=True)
    p.add_argument("--noises", type=str, nargs="+", required=True)
    p.add_argument("--acc_const_noise", type=float, default=0.0)
    p.add_argument("--steer_const_noise", type=float, default=0.0)
    p.add_argument("--num_configs", type=int, default=200)
    p.add_argument("--chunk", type=int, default=20)
    p.add_argument("--out", type=str, default="./data")
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--heartbeat_every", type=int, default=0,
                   help="multi-rank (joins the group torchrun describes; "
                        "each rank solves the chunks it owns, whatever the "
                        "dispatch): probe hosts_alive every N chunks; "
                        "abort cleanly (resumable) on failure")
    p.add_argument("--heartbeat_timeout", type=float, default=30.0)
    p.add_argument("--inner_budget", type=str, default=None,
                   help="SxIT (e.g. 64x12): reduced inner-CEM budget for "
                        "mmd_opt (store tag gains a _S{S}x{IT} suffix)")
    p.add_argument("--outer_budget", type=str, default=None,
                   help="BxIT (e.g. 64x10): reduced outer-CEM budget "
                        "(num_batch x maxiter_cem; store tag gains a "
                        "_B{B}x{IT} suffix)")
    p.add_argument("--scenario_chunk", type=int, default=None,
                   help="scenarios per outer loop of solve_batch (dispatch "
                        "batch; default: env MPC_MMD_SCENARIO_CHUNK or 1)")
    p.add_argument("--kernel", default="laplace",
                   choices=["laplace", "gaussian", "matern52"],
                   help="MMD kernel family (RiskConfig.kernel); non-laplace "
                        "runs tag the store with _K{kernel}")
    p.add_argument("--accept_all", action="store_true",
                   help="persist every solve (no acceptance threshold); "
                        "store tag gains an _all suffix")
    p.add_argument("--dispatch", choices=list(DISPATCHES), default=None,
                   help="pipeline (default): one solve per scenario; "
                        "batch: solve_batch over each chunk, scenario_chunk "
                        "scenarios at once; mesh: batch over the chunks this "
                        "rank owns, a store shard per rank (start the ranks "
                        "with torchrun); each chunk is fetched once")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    p.add_argument("--trace", default=None,
                   help="directory for a torch.profiler trace of the sweep "
                        "and its summary (device busy ms, idle share, top "
                        "kernels)")
    args = p.parse_args(argv)
    joined = False
    if (args.dispatch == "mesh" or args.heartbeat_every) and \
            "WORLD_SIZE" in os.environ and not dist.is_initialized():
        initialize_distributed()       # the group torchrun describes
        joined = True
    try:
        with device_trace(args.trace):
            _run(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args):
    inner_budget = outer_budget = None
    if args.inner_budget:
        inner_budget = tuple(int(v) for v in args.inner_budget.split("x"))
    if args.outer_budget:
        outer_budget = tuple(int(v) for v in args.outer_budget.split("x"))

    logger = MetricLogger(args.metrics)
    for noise in args.noises:
        for lvl in args.noise_levels:
            for np_ in args.num_prime:
                for n_obs in args.num_obs:
                    for n_red in args.num_reduced_sets:
                        for mode in args.costs:
                            store = run_sweep(
                                args.workload, mode, noise, lvl, n_red, n_obs,
                                np_, args.num_configs, args.out, args.chunk,
                                args.acc_const_noise, args.steer_const_noise,
                                logger, args.heartbeat_every,
                                args.heartbeat_timeout, args.dispatch,
                                inner_budget, outer_budget,
                                args.accept_all, args.kernel,
                                args.scenario_chunk, args.device)
                            n = sum(len(a["cx"]) for _, a in store.iter_chunks())
                            print(f"workload={args.workload} cost={mode} "
                                  f"reduced={n_red} obs={n_obs} ts={np_} "
                                  f"noise={noise}@{lvl}: accepted {n}/"
                                  f"{args.num_configs}")


if __name__ == "__main__":
    main()
