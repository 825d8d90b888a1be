"""Scenario-sharded sweeps and statistics over ranks of ``torch.distributed``.

Counterpart of ``mpc_mmd_tpu/parallel/mesh.py``.  There a mesh is a set
of devices that one program spans with ``shard_map``; in PyTorch's idiom
it is a process group with one device per rank, as ``torchrun`` starts it
(``torchrun --nproc_per_node N``), each rank its own process.  A
:class:`Mesh` holds the rank, the world size, the rank's device and the
group; without an initialized group it is a world of one.

* **Scenario axis**: :func:`sharded_sweep` gives each rank a contiguous
  block of the scenarios, solved by ``Solver.solve_batch``, and gathers
  the results to every rank.  Each scenario's draws are keyed by its own
  seed, so every scenario equals its solve alone.
* **Statistics** reduce by ``all_reduce`` (:func:`sweep_statistics`, the
  validator's totals in :func:`sharded_validator`).
* **Candidate axis** (the latency mode, one solve over the ranks):
  ``Solver(..., candidate_mesh=mesh)``, see ``solver.py``.

Collectives run on the rank's device under NCCL.  Gloo, the backend on
the CPU and for several ranks on one card (NCCL refuses two ranks on one
device), reduces CUDA tensors but gathers only host ones, so under gloo
every collective here runs on host copies of its (small) tensors.  A
gather is an ``all_gather`` of every rank's block padded to the largest:
exact, whatever the values.

Multi-host: start every rank with ``torchrun`` (or pass the coordinator's
address, the world size and the rank to :func:`initialize_distributed`).

    torchrun --nproc_per_node 2 -m mpc_mmd_tpu_torch.parallel --device cpu

runs :func:`dryrun` on every rank of the group (``parallel/__main__.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from datetime import timedelta
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ProblemConfig
from ..device import resolve_device
from ..qp import Workspace, build_workspace


# how long a collective may wait for the other ranks before it raises
TIMEOUT = timedelta(seconds=300)


class Mesh(NamedTuple):
    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup]   # None: a world of one


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Join the process group, run a barrier, return this process's rank.

    With ``coordinator_address`` ("host:port" or "tcp://host:port"),
    ``num_processes`` and ``process_id`` the group meets there; without
    them it reads ``torchrun``'s environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), as the JAX package's default auto-detects
    the TPU's.  The backend is NCCL where every local rank has a card of
    its own (LOCAL_WORLD_SIZE, else the world size, at most the cards),
    else gloo: the CPU, or several ranks sharing one card.  A rank's card
    is LOCAL_RANK (else its rank) modulo the cards.  A collective that
    waits longer than :data:`TIMEOUT` raises.
    """
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        kwargs = dict(init_method=init, world_size=num_processes, rank=process_id)
        world, rank = num_processes, process_id
    else:
        kwargs = dict(init_method="env://")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if 0 < local_world <= cards else "gloo"
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    if backend == "nccl":
        dist.barrier(device_ids=[local_rank % cards])
    else:
        dist.barrier()
    return dist.get_rank()


def make_mesh(n_devices: Optional[int] = None, local: bool = False,
              device="cuda") -> Mesh:
    """The mesh of the initialized group (a world of one without one).

    ``local=True`` gives this rank alone, a world of one: what a rank
    needs when it runs its own share of the work apart from the others
    (the sweep CLI's chunk ownership), where a collective of the whole
    group would wait for ranks on other code paths.  ``n_devices``, if
    given, must be the world size: a rank has one device.  ``device``
    "cuda" means this rank's card (see :func:`initialize_distributed`).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    if local or not dist.is_initialized():
        rank, world, group = 0, 1, None
    else:
        rank, world, group = dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a group of "
                         f"{n_devices} ranks, one device each; the group has "
                         f"{world}")
    return Mesh(rank, world, dev, group)


def blocks(n: int, world: int) -> List[Tuple[int, int]]:
    """Rank r's contiguous block [lo, hi) of n items, sizes differing by at
    most one, the larger first."""
    sizes = [n // world + (r < n % world) for r in range(world)]
    ends = np.cumsum([0] + sizes)
    return [(int(ends[r]), int(ends[r + 1])) for r in range(world)]


def _host(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a collective on t runs on a host copy (gloo)."""
    return t.device.type != "cpu" and dist.get_backend(mesh.group) == "gloo"


def all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``op`` of t over the ranks (t itself untouched), on t's device."""
    if mesh.world == 1:
        return t
    x = t.cpu() if _host(mesh, t) else t.clone()
    dist.all_reduce(x, op=op, group=mesh.group)
    return x.to(t.device)


def gather_blocks(t: torch.Tensor, mesh: Mesh, sizes: Sequence[int],
                  dim: int = 0) -> torch.Tensor:
    """Every rank's block t (``sizes[rank]`` long along ``dim``), joined in
    rank order along ``dim`` on every rank."""
    if mesh.world == 1:
        return t
    x = t.movedim(dim, 0)
    if _host(mesh, t):
        x = x.cpu()
    pad = x.new_zeros((max(sizes),) + x.shape[1:])
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(mesh.world)]
    dist.all_gather(parts, pad, group=mesh.group)
    out = torch.cat([p[:n] for p, n in zip(parts, sizes)])
    return out.to(t.device).movedim(0, dim).contiguous()


def _my_block(n: int, mesh: Mesh, what: str) -> Tuple[int, int, List[int]]:
    if n < mesh.world:
        raise ValueError(f"{n} {what} for {mesh.world} ranks: every rank "
                         "needs at least one")
    spans = blocks(n, mesh.world)
    lo, hi = spans[mesh.rank]
    return lo, hi, [b - a for a, b in spans]


def sharded_sweep(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                  mesh: Optional[Mesh] = None):
    """A scenario-sharded sweep: returns ``sweep(seeds, init_state, mean,
    cov, x_obs, y_obs, v_des)`` with seeds (S,) and x_obs, y_obs (S,
    num_obs, num), S at least the world size.  Each rank solves its block
    with ``Solver.solve_batch`` (``MPC_MMD_SCENARIO_CHUNK`` scenarios an
    outer loop); the :class:`~mpc_mmd_tpu_torch.solver.SolveResult` (every field
    with a leading scenario axis) is gathered to every rank."""
    from ..solver import SolveResult, Solver

    mesh = mesh or make_mesh()
    solver = Solver(cfg, device=mesh.device, ws=ws)

    def sweep(seeds, init_state, mean, cov, x_obs, y_obs, v_des) -> SolveResult:
        seeds = [int(s) for s in seeds]
        lo, hi, sizes = _my_block(len(seeds), mesh, "scenarios")
        r = solver.solve_batch(seeds[lo:hi], init_state, mean, cov,
                               solver._input(x_obs)[lo:hi],
                               solver._input(y_obs)[lo:hi], v_des)
        return SolveResult(*(gather_blocks(f, mesh, sizes) for f in r))

    return sweep


def sharded_frenet_sweep(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                         mesh: Optional[Mesh] = None):
    """A scenario-sharded on-road sweep: returns ``sweep(idxs,
    init_state_global, mean, cov, x_obs_traj, y_obs_traj, v_des, frame)``
    with idxs (S,) and the obstacles (S, num_obs, num) in Frenet
    coordinates; ``frame`` is shared by every scenario (the closed-loop
    fleet case).  Each rank runs ``FrenetSolver.solve`` over its block; the
    FrenetSolveResult (leading scenario axis) is gathered to every rank."""
    from ..solver_frenet import FrenetSolveResult, FrenetSolver

    mesh = mesh or make_mesh()
    solver = FrenetSolver(cfg, device=mesh.device, ws=ws)

    def sweep(idxs, init_state_global, mean, cov, x_obs_traj, y_obs_traj,
              v_des, frame) -> FrenetSolveResult:
        idxs = [int(i) for i in idxs]
        lo, hi, sizes = _my_block(len(idxs), mesh, "scenarios")
        xs, ys = solver._input(x_obs_traj), solver._input(y_obs_traj)
        outs = [solver.solve(idxs[i], init_state_global, mean, cov, xs[i], ys[i],
                             v_des, frame) for i in range(lo, hi)]
        return FrenetSolveResult(*(gather_blocks(torch.stack(f), mesh, sizes)
                                   for f in zip(*outs)))

    return sweep


def sharded_validator(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                      n_mc: int = 1000, mesh: Optional[Mesh] = None, noise=None):
    """The Monte-Carlo validator over the ranks: returns ``validate(cx, cy,
    init_state, x_obs_traj, y_obs_traj, seed=0)`` -> (stats, coll_total,
    lane_total).  Each rank validates its block of the solves through
    ``make_validator_core`` with their global row indices, so every solve
    meets the draws the single validator gives it and the per-solve stats
    (gathered to every rank) equal the single validator's bit for bit; the
    totals are ``all_reduce``d sums (int64), computed before the gather."""
    from ..validate import ValidationStats, make_validator_core

    mesh = mesh or make_mesh()
    if ws is None:
        ws = build_workspace(cfg, mesh.device)
    core = make_validator_core(cfg, ws, n_mc, noise)

    def validate(cx, cy, init_state, x_obs_traj, y_obs_traj, seed: int = 0):
        S = len(cx)
        spans = blocks(S, mesh.world)
        lo, hi = spans[mesh.rank]
        if hi > lo:
            stats = core(cx[lo:hi], cy[lo:hi], init_state, x_obs_traj[lo:hi],
                         y_obs_traj[lo:hi], seed, range(lo, hi))
        else:
            empty = lambda dt: torch.zeros(0, dtype=dt, device=mesh.device)
            stats = ValidationStats(empty(torch.int32), empty(torch.int32),
                                    empty(torch.float32))
        coll_total = all_reduce(stats.coll_count.sum(dtype=torch.int64), mesh)
        lane_total = all_reduce(stats.lane_count.sum(dtype=torch.int64), mesh)
        sizes = [b - a for a, b in spans]
        stats = ValidationStats(*(gather_blocks(f, mesh, sizes) for f in stats))
        return stats, coll_total, lane_total

    return validate


def sweep_statistics(cfg: ProblemConfig, mesh: Optional[Mesh] = None):
    """``stats(risk, threshold)`` -> (count accepted, mean risk, max risk)
    over the ranks, each passing its own block of per-scenario risks:
    ``all_reduce`` SUM of the accepted counts, of the sums and of the
    counts, and MAX of the maxima; the analog of the reference's host-side
    threshold filter (main_mpc.py:121)."""
    mesh = mesh or make_mesh()

    def stats(risk: torch.Tensor, threshold: float):
        risk = risk.to(torch.float32)
        accepted = all_reduce((risk <= threshold).sum(dtype=torch.float32), mesh)
        total = all_reduce(risk.sum(), mesh)
        count = all_reduce(torch.full((), float(risk.numel()), device=risk.device),
                           mesh)
        mx = risk.max() if risk.numel() else torch.full((), -torch.inf,
                                                          device=risk.device)
        return accepted, total / count, all_reduce(mx, mesh, dist.ReduceOp.MAX)

    return stats


def dryrun(n_devices: int, device="cuda") -> None:
    """The whole distributed surface at tiny shapes on a group of
    ``n_devices`` ranks (a world of one without a group): a sharded
    ``mmd_opt`` sweep, its statistics, the sharded validator, a
    candidate-split solve and a sharded on-road sweep, each finite."""
    from ..config import onroad_workload, static_workload
    from ..dynamics import constant_velocity_obstacles
    from ..frenet import path_parameters
    from ..solver import Solver

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    cfg = static_workload(num_reduced=2, num_obs=1, num_prime=10, mode="mmd_opt")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2),
                      beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=2))
    ws = build_workspace(cfg, dev)
    S = n_devices
    one = lambda v: torch.full((1,), v, device=dev)
    xt, yt, _ = constant_velocity_obstacles(one(40.0), one(-1.75), one(0.0),
                                            one(0.0), one(0.0), ws.tot_time)
    xt, yt = xt.expand(S, 1, -1), yt.expand(S, 1, -1)
    init_state = [0.0, 1.75, 5.0, 0.0, 0.0, 0.0]
    mean = [15.0] * 4 + [0.0] * 4
    cov = np.diag([20.0] * 4 + [100.0] * 4)

    out = sharded_sweep(cfg, ws, mesh)(range(S), init_state, mean, cov, xt, yt, 15.0)
    if tuple(out.cx.shape) != (S, cfg.horizon.nvar) or not bool(out.cx.isfinite().all()):
        raise FloatingPointError("dryrun: non-finite or misshapen sweep output")
    lo, hi = blocks(S, mesh.world)[mesh.rank]
    n_acc, _, _ = sweep_statistics(cfg, mesh)(out.risk_obs[lo:hi], 1.0e9)
    if int(n_acc) != S:
        raise RuntimeError(f"dryrun: {int(n_acc)} of {S} scenarios accepted")

    vstats, coll_total, _ = sharded_validator(cfg, ws, n_mc=8, mesh=mesh)(
        out.cx, out.cy, init_state, xt, yt, 0)
    if vstats.coll_count.shape != (S,) or int(coll_total) != int(vstats.coll_count.sum()):
        raise RuntimeError("dryrun: the sharded validator's totals disagree")

    r = Solver(cfg, device=dev, ws=ws, candidate_mesh=mesh).solve(
        0, init_state, mean, cov, xt[0], yt[0], 15.0)
    if not bool(r.cx.isfinite().all()):
        raise FloatingPointError("dryrun: non-finite candidate-split solve")

    fcfg = onroad_workload(num_reduced=2, num_obs=1, num_prime=10, mode="mmd_opt")
    fcfg = fcfg.replace(cem=dataclasses.replace(fcfg.cem, maxiter_cem=2),
                        beta_cem=dataclasses.replace(fcfg.beta_cem, maxiter=2))
    fws = build_workspace(fcfg, dev)
    num_path = fcfg.frenet.num_path
    frame = path_parameters(torch.linspace(0.0, fcfg.frenet.lookahead, num_path,
                                           device=dev),
                            torch.zeros(num_path, device=dev))
    tot = torch.linspace(0.0, fcfg.horizon.t_fin, fcfg.horizon.num, device=dev)
    xo, yo, _ = constant_velocity_obstacles(one(30.0), one(0.0), one(0.0),
                                            one(0.0), one(0.0), tot)
    fout = sharded_frenet_sweep(fcfg, fws, mesh)(
        range(S), [0.0, 0.0, 5.0, 0.0, 0.0, 0.0], mean, cov,
        xo.expand(S, 1, -1), yo.expand(S, 1, -1), 8.0, frame)
    if tuple(fout.cx.shape) != (S, fcfg.horizon.nvar) or not bool(fout.cx.isfinite().all()):
        raise FloatingPointError("dryrun: non-finite or misshapen on-road output")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="dryrun on every rank of the "
                                "group torchrun starts (a world of one alone)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, this rank's card)")
    args = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        initialize_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        dryrun(world, device=args.device)
        print(f"dryrun ok on rank {dist.get_rank() if world > 1 else 0} of {world}",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
