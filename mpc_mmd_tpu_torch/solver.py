"""Outer CEM solver: the risk-aware MPC solve in the ``mmd_opt``,
``mmd_random``, ``cvar`` and ``saa`` modes.

Counterpart of ``mpc_mmd_tpu/solver.py``.  One outer iteration:

  guess QP -> AM projection -> controls (kernel (d)) -> stable sort by
  projection residual -> noisy rollouts (K4n) -> obstacle risk -> keep the
  ellite_num_cost lowest risks -> lane risk -> scalar cost -> elites ->
  CEM update (kernel (e), in every mode).

``mmd_opt`` rolls R^2 mother rollouts per candidate, refits them and
takes their distance matrices (kernel (f)), and picks a weighted reduced
set of R with the inner beta-CEM (kernel (c), in the form of each
selection) before the MMD risks.  The other modes
roll R rollouts per candidate: ``mmd_random`` scores them by MMD with
uniform weights 1/R and bandwidth 0.01 and no lane risk, ``cvar`` and
``saa`` by CVaR and by the violation fraction.

The JAX package runs the loop as one ``lax.scan`` inside one jitted
program.  Here a solve is a host prologue, which turns the arguments into
named input tensors (the noise source's key table of the chunk's draws,
the initial state, the CEM moments, the obstacles, ``v_des``), and a device
body, which reads only those and the solver's fixed tensors: the workspace
and the solver-fixed draws.  The body is a Python loop over the outer
iterations that leaves every value on the device (no host synchronisation
inside a solve).  On the card it runs as a CUDA graph (``graph.py``,
``graph`` below): captured at a solver's first solve of a shape and
replayed for every later one, the counterpart of ``jax.jit``; on the CPU,
and with ``graph=False``, eagerly.  Every sort is stable, as
``jnp.argsort`` is.  The loop (``SolverSetup._outer_cem``) carries a
leading scenario axis: ``solve`` is a chunk of one, and ``solve_batch``
runs ``scenario_chunk`` scenarios through it at once, as the JAX package's
``lax.map(..., batch_size=)`` vmaps the solve over a chunk, so each kernel
launch serves the chunk.  It is shared with the on-road solve
(``solver_frenet.py``, always a chunk of one); each solver supplies the
hooks that differ.

The "exact" strategy (``cfg.solve_strategy``) is the JAX package's
reference-parity path: KKT systems solved by LU, and the per-candidate
inner CEM of ``reduced_set.select_reduced_set``.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import risk
from .config import ProblemConfig
from .device import resolve_device, to_device
from .dynamics import beta_parameters, perturb_controls
from .graph import GraphCache
from .noise import JaxNoise, solve_draws
from .ops import inner_prologue, noisy_rollout, outer_project, outer_tail
from .ops.outer_project import outer_project_plain
from .ops.outer_tail import candidates, chain_tail
from .ops.rollout import paired_rollouts
from .qp import Workspace, boundary_vectors, build_workspace, refit_coefficients
from .reduced_set import (ReducedSet, inner_fixed, select_reduced_set,
                          select_reduced_set_batched, selection_key)
from .sampling import initial_params


class SolveResult(NamedTuple):
    """Per-solve outputs, as ``mpc_mmd_tpu.solver.SolveResult``."""

    cx: torch.Tensor          # (nvar,) best-candidate Bernstein x coefficients
    cy: torch.Tensor
    risk_lane: torch.Tensor   # ()
    risk_obs: torch.Tensor    # ()
    beta: torch.Tensor        # (num_reduced,)
    sigma: torch.Tensor       # ()
    res_beta: torch.Tensor    # (beta_cem.maxiter,)
    res: torch.Tensor         # (maxiter_cem,) best scalar cost per iteration
    res_2: torch.Tensor       # (maxiter_cem,) projection residual of the best
    mean_param: torch.Tensor  # (8,)
    cov_param: torch.Tensor   # (8, 8)


def rollout_draws(cfg: ProblemConfig, noise, keys: torch.Tensor,
                  acc_T: torch.Tensor, steer_T: torch.Tensor, eps=None):
    """The draws of the noisy controls of a chunk's candidates (N, C, T),
    each scenario from its row of the iteration's column ``keys`` of the
    noise source's key table (see :mod:`mpc_mmd_tpu_torch.noise`): d_acc,
    d_steer, (N, 1, R, T) standard normals under gaussian noise, (N, C, R,
    T) Beta draws under Beta noise, and eps_const (N, 1, R, T).  ``eps``:
    the iteration's (eps_acc, eps_steer, eps_const) of the solve's
    ``solve_draws``, else asked of ``noise.rollout_eps``."""
    R, T = cfg.risk.num_reduced, acc_T.shape[-1]
    if eps is None:
        eps = noise.rollout_eps(keys, R, T)
    d_acc, d_steer, eps_const = (e[:, None] for e in eps)
    if cfg.noise.kind == "beta":
        d_acc, d_steer = noise.rollout_beta(
            keys, R, *beta_parameters(acc_T, steer_T, cfg.noise))
    return d_acc, d_steer, eps_const


def noisy_controls(cfg: ProblemConfig, noise, keys: torch.Tensor,
                   acc_T: torch.Tensor, steer_T: torch.Tensor, eps=None):
    """R noisy variants (N, C, R, T) of the controls (N, C, T) of a chunk's
    candidates, from :func:`rollout_draws`."""
    return perturb_controls(acc_T, steer_T,
                            *rollout_draws(cfg, noise, keys, acc_T, steer_T, eps),
                            cfg.noise)


class Step(NamedTuple):
    """What an outer iteration's hooks draw from: the iteration's column of
    the key table (the Beta draws) and its rollout normals of the solve's
    ``solve_draws`` (eps_acc, eps_steer, eps_const, or None)."""
    keys: torch.Tensor
    eps: Optional[tuple]


def batched_rollouts(cfg: ProblemConfig, a_n: torch.Tensor, s_n: torch.Tensor,
                     state0: torch.Tensor, mother: bool):
    """Rollouts of every candidate's noisy controls (..., C, R, T) as one
    flat-lane K4 call (``ops.rollout.paired_rollouts``): x, y (..., C, n,
    T), n = R^2 mother rollouts with ``mother``, else R."""
    return paired_rollouts(a_n, s_n, state0, cfg.horizon.dt, cfg.vehicle.wheel_base,
                           mother)


def select_reduced(cfg: ProblemConfig, ws: Workspace, xr: torch.Tensor,
                   yr: torch.Tensor, inner, fixed=None,
                   prologue: bool = False) -> ReducedSet:
    """The mother rollouts (N, C, M, T) of a chunk refitted and reduced,
    every candidate of every scenario in one inner CEM; the reduced set's
    fields come back as (N, C, ...).  With ``prologue``, the refit and the
    distance matrices are kernel (f)'s (``ops.inner_prologue``), else the
    chain's; ``fixed``: the hoisted ``reduced_set.inner_fixed`` of the
    draws ``inner`` (prefactored strategy)."""
    lead, (M, T) = xr.shape[:-2], xr.shape[-2:]
    nvar = cfg.horizon.nvar
    rolls = (xr.reshape(-1, M, T), yr.reshape(-1, M, T), inner)
    if prologue:
        pro = inner_prologue(ws, xr, yr, cfg.risk.kernel)
        rs = select_reduced_set_batched(cfg, pro.cx, pro.cy, *rolls,
                                        distances=(pro.D, pro.D2), fixed=fixed)
    else:
        cxr, cyr = refit_coefficients(ws, xr.reshape(-1, T), yr.reshape(-1, T),
                                      xr.shape[0])
        flat = (cxr.reshape(-1, M, nvar), cyr.reshape(-1, M, nvar), *rolls)
        rs = (select_reduced_set(cfg, *flat) if cfg.solve_strategy == "exact"
              else select_reduced_set_batched(cfg, *flat, fixed=fixed))
    return ReducedSet(*(f.reshape(*lead, *f.shape[1:]) for f in rs))


MODES = ("mmd_opt", "mmd_random", "cvar", "saa")
STRATEGIES = ("prefactored", "exact")


class GlueRoutes(NamedTuple):
    """Which of the outer iteration's steps around the rollouts run as
    kernels (``SolverSetup._glue_routes``)."""
    noisy_rollout: bool    # K4n: the noisy controls formed inside the rollout
    inner_prologue: bool   # kernel (f): the refit and distance matrices
    frenet_points: bool    # kernel (g): the on-road rollouts' Frenet points
    frenet_states: bool = False  # kernel (g)'s state form: the on-road initial states


class SolverSetup:
    """What a solver builds once: the checked configuration, its device,
    the workspace, the noise source and the solver-fixed draws (the initial
    parameter batch and, in ``mmd_opt``, the inner CEM's), and on the card
    the cache of its CUDA graphs; the outer CEM loop (``_outer_cem``) that
    both solvers run through their hooks; and :meth:`_run`, which runs a
    solve's body eagerly or as a graph.

    ``graph``: None (the default) runs the body as a CUDA graph wherever
    the port can, on the card, and eagerly on the CPU, under the "exact"
    strategy (an LU and a per-candidate inner CEM, kept eager) and with a
    candidate mesh of several ranks (collectives inside the solve); True
    asks for the graph and raises where there is none; False runs eagerly
    (the counterpart of ``jax.disable_jit``).  A graph replays the noise
    source's draws from the key table it is given, so a source that draws
    on the host (``TorchNoise``) is refused with a graph.
    """

    # the names of the kept candidates' values a solve returns of its best
    BEST: tuple = ()
    # the on-road cost (sampling.candidate_cost) and the projection's steering
    FRENET = False

    def __init__(self, cfg: ProblemConfig, device, noise, ws: Optional[Workspace],
                 modes, graph: Optional[bool] = None):
        if cfg.risk.mode not in modes:
            raise NotImplementedError(
                f"{type(self).__name__} has the modes {modes}, got "
                f"{cfg.risk.mode!r}")
        if cfg.solve_strategy not in STRATEGIES:
            raise ValueError(f"solve_strategy must be one of {STRATEGIES}, "
                             f"got {cfg.solve_strategy!r}")
        if cfg.rollout_backend != "auto":
            raise NotImplementedError("the PyTorch port has only "
                                      "rollout_backend='auto'")
        if cfg.cem.maxiter_cem < 1 or cfg.beta_cem.maxiter < 1:
            raise ValueError("maxiter_cem and beta_cem.maxiter must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ws = ws if ws is not None else build_workspace(cfg, self.device)
        if noise is None:
            noise = JaxNoise(self.device)
        self.noise = noise
        eager = self._eager_reason()
        self.graph = eager is None if graph is None else bool(graph)
        if self.graph and not getattr(noise, "capturable", True):
            raise ValueError(f"{type(noise).__name__} draws on the host, which a "
                             f"CUDA graph cannot replay: pass graph=False")
        if self.graph and eager:
            raise ValueError(f"graph=True, but {eager}: pass graph=None or False")
        self._graphs = GraphCache(self.device) if self.graph else None

    def _eager_reason(self) -> Optional[str]:
        """Why a solve of this solver runs eagerly, or None."""
        if self.device.type != "cuda":
            return "a CUDA graph needs the card"
        if self.cfg.solve_strategy == "exact":
            return 'the "exact" strategy runs eagerly'
        return None

    def _routes(self):
        """(kernel (d), kernel (e)): whether an outer iteration runs its
        guess QP, projection and controls as ``ops.outer_project`` (the
        obstacle-active projection of ``with_obstacle_terms`` too), and its
        tail (the mode's risk, sort, cost, CEM update) as
        ``ops.outer_tail``.  Each wrapper launches its kernel on the card
        and runs its plain version on the CPU.  These keep their chains of
        PyTorch operations on every device: the "exact" strategy (LU
        solves, the reference's inner CEM) both; a candidate mesh of
        several ranks (each rank scores its block) the tail."""
        prefactored = self.cfg.solve_strategy == "prefactored"
        return prefactored, prefactored and not self._split()

    def _glue_routes(self) -> GlueRoutes:
        """Whether an outer iteration forms its noisy controls inside the
        rollout (``ops.noisy_rollout``, K4n), refits the mother rollouts and
        takes their distance matrices as ``ops.inner_prologue`` (kernel
        (f), ``mmd_opt``) and converts the on-road rollouts to Frenet as
        ``ops.frenet_points`` (kernel (g)), and whether an on-road solve
        forms its noisy initial states and boundary rows as
        ``ops.frenet_states`` (kernel (g)'s state form, ``det`` included).
        Each wrapper launches its kernel on the card and runs its plain
        version on the CPU.  These keep their chains on every device: the
        "exact" strategy and a candidate mesh of several ranks (each rank
        rolls out its block of the candidates); the ``det`` baseline rolls
        nothing out."""
        cfg = self.cfg
        kernels = cfg.solve_strategy == "prefactored" and not self._split()
        glue = kernels and cfg.risk.mode != "det"
        return GlueRoutes(glue, glue and cfg.risk.mode == "mmd_opt",
                          glue and self.FRENET, kernels and self.FRENET)

    def _split(self) -> bool:
        """Whether a candidate mesh splits the solve over several ranks."""
        return False

    def _picked(self, ens, n_ix, pos):
        """The values beyond the trajectory and the risks that ``BEST``
        names, of the pick ``pos`` (N,) of scenarios ``n_ix`` in the last
        iteration's ensemble ``ens``: none."""
        return {}

    def graph_stats(self):
        """Per captured graph: its key, nodes, capture and instantiation
        seconds, replays and launches per replay (``GraphCache.stats``)."""
        return [] if self._graphs is None else self._graphs.stats()

    # the solver-fixed draws, made at the first solve that needs them (a
    # solver that only resumes finished work draws nothing)
    @functools.cached_property
    def _z0(self) -> torch.Tensor:
        c = self.cfg.cem
        return self.noise.initial_z(c.num_batch, c.num_params)

    @functools.cached_property
    def _inner(self):
        cfg, bc = self.cfg, self.cfg.beta_cem
        draw = (self.noise.inner_exact if cfg.solve_strategy == "exact"
                else self.noise.inner_cem)
        return draw(bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite,
                    bc.maxiter)

    @functools.cached_property
    def _inner_fixed(self):
        """The inner CEM's first batch and affine resample coefficients
        (``reduced_set.inner_fixed``) of the solver-fixed draws, made once
        beside them (prefactored strategy; None under "exact")."""
        if self.cfg.solve_strategy == "exact":
            return None
        return inner_fixed(self.cfg, self._inner)

    def _rollouts(self, step: Step, acc_T, steer_T, state0, mother: bool,
                  mine=slice(None)):
        """The noisy rollouts x, y (N, c, n, T) of the candidates ``mine`` of
        the controls (N, C, T), from the iteration's ``step`` (its key
        column and rollout normals) and the initial state(s) ``state0``:
        K4n where ``_glue_routes`` sends them (every candidate), else the
        chain of :func:`noisy_controls` and :func:`batched_rollouts` (K4)."""
        cfg = self.cfg
        if self._glue_routes().noisy_rollout:
            return noisy_rollout(acc_T, steer_T,
                                 *rollout_draws(cfg, self.noise, step.keys, acc_T, steer_T,
                                                step.eps),
                                 state0, cfg.noise, cfg.horizon.dt, cfg.vehicle.wheel_base,
                                 mother)
        a_n, s_n = noisy_controls(cfg, self.noise, step.keys, acc_T, steer_T, step.eps)
        return batched_rollouts(cfg, a_n[:, mine], s_n[:, mine], state0, mother)

    @staticmethod
    def _input(a) -> torch.Tensor:
        """A float argument as a float32 tensor where it lies (host data
        that is not a tensor copied, so the caller's arrays stay
        untouched)."""
        if torch.is_tensor(a):
            return a.to(torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def _run(self, body: Callable[..., Dict[str, torch.Tensor]],
             **inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A solve's body on its named inputs (tensors on any device): as
        the CUDA graph of their shapes (and of the inner CEM's selection,
        which the body fixes), or eagerly on the inputs moved to the
        device.  The solver-fixed draws (and what the inner CEM takes of
        them alone) are made first, outside any graph."""
        self._z0
        if self.cfg.risk.mode == "mmd_opt":
            self._inner
            self._inner_fixed
        if self._graphs is None:
            return body(**{k: to_device(t, self.device) for k, t in inputs.items()})
        key = tuple((k, tuple(t.shape), t.dtype) for k, t in inputs.items())
        if self.cfg.risk.mode == "mmd_opt":
            key += (selection_key(self.cfg),)
        return self._graphs.run(key, inputs, body)

    def _draws(self, keys, init=None):
        """The solve's Gaussian draws, every outer iteration's at once, from
        the key table ``keys`` (N, maxiter_cem, ...) on the device
        (``noise.solve_draws``: one launch of kernel (a)'s plan form on the
        default noise): the rollout normals unless ``det`` rolls nothing
        out, the outer CEM's resample and, given ``init`` = (init_key, n),
        the noisy initial states'."""
        cfg, c = self.cfg, self.cfg.cem
        R = None if cfg.risk.mode == "det" else cfg.risk.num_reduced
        return solve_draws(self.noise, keys, R, cfg.horizon.num_prime,
                           c.num_batch - c.ellite_num, c.num_params, init)

    def _outer_cem(self, keys, draws, ctx, b_eq_x, b_eq_y, mean, cov, x_obs,
                   y_obs, v_des):
        """The outer CEM loop over a chunk of N scenarios, one iteration as
        the module docstring lists it, every step on all N at once.

        ``keys`` the noise source's key table of the N scenarios (N,
        maxiter_cem, ...), on the device, and ``draws`` its
        :class:`~mpc_mmd_tpu_torch.noise.SolveDraws` (``_draws``); v_des a
        0-d tensor; b_eq_x,
        b_eq_y (nb, .), mean (8,) and cov (8, 8) shared by the chunk;
        x_obs, y_obs (N, num_obs, num); ``ctx`` is what the hooks read of
        the solve (the rollouts' initial state, the path).  The projection
        and the controls run on the chunk's N nb candidates as rows,
        scenario after scenario; everything after them on (N, nb, ...), in
        the order of a stable argsort by projection residual, every later
        sort a stable argsort along the candidate axis and every gather per
        scenario.  ``_routes`` says which stages run as kernels (d) and
        (e).  Returns the last iteration's best candidate {name: (N, ...)}
        for the names in ``BEST``, the best cost and its projection residual
        of every iteration (N, maxiter_cem), and the final CEM moments (N,
        8), (N, 8, 8).

        The subclass's hooks:

        * ``_path(ctx)``: the path's arc_vec and kappa as keyword
          arguments of the projection, or none;
        * ``_ensemble(ctx, step, acc_T, steer_T)``: the candidates' reduced
          rollouts {"x", "roll": (N, nb, R, T), "beta": (N, nb, R), "sigma":
          (N, nb), ...} from the iteration's :class:`Step` (its column of
          the key table and its rollout normals), which kernel (e) scores
          (None where the mode reads none);
        * ``_risks(ctx, step, acc_T, steer_T, x_obs, y_obs)``: the
          obstacle risk (N, nb) and {name: (N, nb, ...)} the cost reads,
          on the chain's path;
        * ``_picked(ens, n_ix, pos)``: the pick's values of the last
          ensemble that ``BEST`` names.
        """
        cfg, ws = self.cfg, self.ws
        N = keys.shape[0]
        nb, nvar, T = cfg.cem.num_batch, cfg.horizon.nvar, cfg.horizon.num_prime
        rows = N * nb
        kernel_d, kernel_e = self._routes()
        path = self._path(ctx)
        b_eq_x, b_eq_y = b_eq_x.repeat(N, 1), b_eq_y.repeat(N, 1)
        params = initial_params(cfg, mean, cov, self._z0).expand(N, nb, -1)
        mean, cov = mean.expand(N, -1), cov.expand(N, -1, -1)

        n_ix = torch.arange(N, device=self.device)
        per = n_ix[:, None]

        zeros = lambda *s: torch.zeros(s, device=self.device)
        lamda_x, lamda_y = zeros(rows, nvar), zeros(rows, nvar)
        s_lane = zeros(rows, 2 * (cfg.horizon.num - 1))
        res, res_2 = zeros(N, cfg.cem.maxiter_cem), zeros(N, cfg.cem.maxiter_cem)

        for it in range(cfg.cem.maxiter_cem):
            project = outer_project if kernel_d else outer_project_plain
            pj = project(cfg, ws, params.reshape(rows, -1), b_eq_x, b_eq_y, lamda_x,
                         lamda_y, s_lane, x_obs, y_obs, **path)
            order = torch.argsort(pj.res_norm.reshape(N, nb), dim=1, stable=True)
            in_order = lambda t: t.reshape(N, nb, *t.shape[1:])[per, order]
            steer = pj.steering if self.FRENET else pj.steer
            acc_T, steer_T = in_order(pj.acc[:, :T]), in_order(steer[:, :T])

            step = Step(keys[:, it], None if draws.eps is None else draws.eps[it])
            z = draws.cem_z[it]
            if kernel_e:
                ens = self._ensemble(ctx, step, acc_T, steer_T)
                tail = outer_tail(cfg, self.FRENET, pj, order, params, ens["beta"],
                                  ens["sigma"], ens["x"], ens["roll"], x_obs, y_obs, z,
                                  mean, cov, v_des, res, res_2, it)
            else:
                risk_obs, ens = self._risks(ctx, step, acc_T, steer_T, x_obs, y_obs)
                cand = candidates(pj, order, params, self.FRENET)
                cand.update(ens)
                tail = chain_tail(cfg, self.FRENET, risk_obs, cand, z, mean, cov, v_des,
                                  res, res_2, it)
            mean, cov, params = tail.mean, tail.cov, tail.params
            lamda_x, lamda_y, s_lane = pj.lamda_x, pj.lamda_y, pj.s_lane

        # the last iteration's pick: its projection row and its ensemble
        pos = tail.best
        row = order[n_ix, pos]
        at_row = lambda t: t.reshape(N, nb, *t.shape[1:])[n_ix, row]
        best = dict(cx=at_row(pj.c_x), cy=at_row(pj.c_y), steer=at_row(steer),
                    risk_obs=tail.risk_obs, risk_lane=tail.risk_lane,
                    **self._picked(ens, n_ix, pos))
        return {name: best[name] for name in self.BEST}, res, res_2, mean, cov


class Solver(SolverSetup):
    """Builds the workspace and the fixed draws once; ``solve`` runs one MPC
    solve on ``device``, ``solve_batch`` many.

    Usage::

        solver = Solver(dynamic_workload(mode="cvar"))      # on the card
        result = solver.solve(seed, init_state, mean, cov, x_obs, y_obs, v_des)
        cpu_solver = Solver(cfg, device="cpu")              # plain twins

    ``device`` defaults to ``"cuda"``; without a card that raises a
    ``RuntimeError`` naming ``device="cpu"``, the only way onto the CPU.
    On the card a solve or a chunk is one CUDA graph replay (``graph``:
    see :class:`SolverSetup`), captured at the first solve of its shape;
    ``graph=False`` runs it eagerly.
    ``noise`` defaults to :class:`JaxNoise` on ``device``: the JAX
    package's draws for the same ``idx_mpc``.  On a CUDA
    device the rollouts, the inner CEM and the outer iteration's glue run
    the hand-written kernels (``ops``); on the CPU their plain twins.
    ``cfg.solve_strategy`` "exact" runs the reference-parity inner CEM
    (``reduced_set.select_reduced_set``) and KKT solves; only K4 of the
    kernels is on its path.  ``scenario_chunk`` (default
    ``MPC_MMD_SCENARIO_CHUNK``, else 1) is how many scenarios
    ``solve_batch`` runs at once: one outer loop over a leading scenario
    axis, every kernel launched once for the whole chunk.
    ``candidate_mesh`` (a ``parallel.mesh.Mesh`` of the ranks, each on its
    own device, ``device`` this rank's) splits every solve's candidates
    over the ranks for the rollouts, the inner CEM and the risk, as the
    JAX package's candidate mesh does (see :meth:`_risks`).
    """

    def __init__(self, cfg: ProblemConfig, device="cuda", noise=None,
                 ws: Optional[Workspace] = None,
                 scenario_chunk: Optional[int] = None, candidate_mesh=None,
                 graph: Optional[bool] = None):
        if scenario_chunk is None:
            scenario_chunk = int(os.environ.get("MPC_MMD_SCENARIO_CHUNK", "1"))
        self.scenario_chunk = max(1, scenario_chunk)
        if candidate_mesh is not None and candidate_mesh.world > cfg.cem.num_batch:
            raise ValueError(f"{cfg.cem.num_batch} candidates for "
                             f"{candidate_mesh.world} ranks")
        self.candidate_mesh = candidate_mesh
        super().__init__(cfg, device, noise, ws, MODES, graph)

    def _eager_reason(self) -> Optional[str]:
        if self._split():
            return "a candidate mesh of several ranks has collectives inside the solve"
        return super()._eager_reason()

    BEST = ("cx", "cy", "risk_lane", "risk_obs", "beta", "sigma", "res_beta")

    def _split(self) -> bool:
        return self.candidate_mesh is not None and self.candidate_mesh.world > 1

    def _path(self, state0):
        return {}

    def _ensemble(self, state0, step, acc_T, steer_T, mine=slice(None)):
        """The rollouts of the candidates ``mine`` of the noisy controls
        (N, C, T): in ``mmd_opt`` R^2 mother rollouts reduced to R ({"x",
        "roll": (N, c, R, T), "beta": (N, c, R), "sigma": (N, c),
        "res_beta": the inner residuals (N, c, maxiter)}), else R rollouts
        with the uniform weights and bandwidth (``risk.uniform_weights``)
        where the mode reads them (``mmd_random``) and None in ``cvar`` and
        ``saa``."""
        cfg = self.cfg
        mode = cfg.risk.mode
        xr, yr = self._rollouts(step, acc_T, steer_T, state0, mode == "mmd_opt", mine)
        if mode == "mmd_opt":
            rs = select_reduced(cfg, self.ws, xr, yr, self._inner, self._inner_fixed,
                                self._glue_routes().inner_prologue)
            return dict(x=rs.x_red, roll=rs.y_red, beta=rs.beta, sigma=rs.sigma,
                        res_beta=rs.res)
        beta = sigma = None
        if mode == "mmd_random":
            beta, sigma = risk.uniform_weights(cfg, xr.shape[:-2], self.device)
        return dict(x=xr, roll=yr, beta=beta, sigma=sigma)

    def _picked(self, ens, n_ix, pos):
        """The pick's beta (N, R), sigma (N,) and inner residuals (N,
        maxiter): its reduced set's in ``mmd_opt``, else the uniform weights
        and no residual."""
        if self.cfg.risk.mode == "mmd_opt":
            return {name: ens[name][n_ix, pos] for name in ("beta", "sigma", "res_beta")}
        beta, sigma = risk.uniform_weights(self.cfg, pos.shape, self.device)
        return dict(beta=beta, sigma=sigma,
                    res_beta=torch.zeros(*pos.shape, self.cfg.beta_cem.maxiter,
                                         device=self.device))

    def _risks(self, state0, step, acc_T, steer_T, x_obs, y_obs):
        """Obstacle risk (N, C) and, per candidate, the rollouts the lane
        risk reads (N, C, R, T), beta (N, C, R), sigma (N, C) and in
        ``mmd_opt`` the inner residuals (N, C, maxiter).

        With a ``candidate_mesh`` (the latency mode) every rank draws the
        noisy controls of all C candidates, as the solve alone does, rolls
        out, reduces and scores its block of them (``parallel.mesh.blocks``),
        and gathers risk_obs and the per-candidate values back to all C
        (mpc_mmd_tpu/solver.py:259-268): the selection and the CEM update
        after it run on every rank alike."""
        cfg = self.cfg
        mesh = self.candidate_mesh
        mine, gather = slice(None), lambda t: t
        if self._split():
            from .parallel.mesh import blocks, gather_blocks
            spans = blocks(acc_T.shape[1], mesh.world)
            mine = slice(*spans[mesh.rank])
            sizes = [hi - lo for lo, hi in spans]
            gather = lambda t: gather_blocks(t, mesh, sizes, dim=1)
        e = self._ensemble(state0, step, acc_T, steer_T, mine)
        risk_obs = risk.obstacle_risk(cfg, e["beta"], e["sigma"], e["x"], e["roll"], x_obs,
                                      y_obs)
        if cfg.risk.mode == "mmd_opt":
            return gather(risk_obs), {name: gather(e[name])
                                      for name in ("roll", "beta", "sigma", "res_beta")}
        # the chain's lane risks read weights in every mode
        beta, sigma = risk.uniform_weights(cfg, acc_T.shape[:-1], self.device)
        return gather(risk_obs), dict(roll=gather(e["roll"]), beta=beta, sigma=sigma)

    def _body(self, keys, init_state, mean, cov, x_obs, y_obs, v_des):
        """The device body of a chunk's solve: the boundary rows and the
        rollouts' initial state, the solve's draws, then the outer loop;
        {field: (N, ...)}."""
        b_eq_x, b_eq_y = boundary_vectors(self.cfg, init_state)
        state0 = torch.stack((init_state[0], init_state[1], init_state[2],
                              init_state[3],
                              torch.atan2(init_state[3], init_state[2])))
        best, res, res_2, mean, cov = self._outer_cem(
            keys, self._draws(keys), state0, b_eq_x, b_eq_y, mean, cov, x_obs, y_obs,
            v_des)
        return dict(best, res=res, res_2=res_2, mean_param=mean, cov_param=cov)

    def _solve_chunk(self, seeds, init_state, mean_param, cov_param,
                     x_obs_trajs, y_obs_trajs, v_des) -> SolveResult:
        """The scenarios ``seeds`` in one outer loop; every field (N, ...)."""
        return SolveResult(**self._run(
            self._body, keys=self.noise.keys(seeds, self.cfg.cem.maxiter_cem),
            init_state=self._input(init_state), mean=self._input(mean_param),
            cov=self._input(cov_param), x_obs=x_obs_trajs, y_obs=y_obs_trajs,
            v_des=self._input(v_des)))

    @torch.no_grad()
    def solve(self, idx_mpc: int, init_state, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des) -> SolveResult:
        """One MPC solve, a chunk of one; arguments as
        ``mpc_mmd_tpu.Solver.solve``.

        init_state (6,) = [x, y, vx, vy, ax, ay]; mean_param (8,),
        cov_param (8, 8); x_obs_traj, y_obs_traj (num_obs, num); v_des a
        float.  Arrays may be numpy, tensors or sequences.
        """
        r = self._solve_chunk([idx_mpc], init_state, mean_param, cov_param,
                              self._input(x_obs_traj)[None],
                              self._input(y_obs_traj)[None], v_des)
        return SolveResult(*(f[0] for f in r))

    @torch.no_grad()
    def solve_batch(self, seeds, init_state, mean_param, cov_param,
                    x_obs_trajs, y_obs_trajs, v_des) -> SolveResult:
        """One solve per scenario, stacked along a leading axis, as
        ``mpc_mmd_tpu.Solver.solve_batch``: ``scenario_chunk`` scenarios at
        a time (the last chunk may be short), each scenario's result the
        one :meth:`solve` gives it.

        seeds (n,), each scenario's ``idx_mpc``; x_obs_trajs, y_obs_trajs
        (n, num_obs, num); the other arguments as :meth:`solve`, shared by
        every scenario.
        """
        seeds = [int(s) for s in seeds]
        xs, ys = self._input(x_obs_trajs), self._input(y_obs_trajs)
        c = self.scenario_chunk
        parts = [self._solve_chunk(seeds[lo:lo + c], init_state, mean_param,
                                   cov_param, xs[lo:lo + c], ys[lo:lo + c], v_des)
                 for lo in range(0, len(seeds), c)]
        return SolveResult(*(torch.cat(f) for f in zip(*parts)))
