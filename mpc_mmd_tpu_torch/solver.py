"""Outer CEM solver: the risk-aware MPC solve in the ``mmd_opt``,
``mmd_random``, ``cvar`` and ``saa`` modes.

Counterpart of ``mpc_mmd_tpu/solver.py``.  One outer iteration:

  guess QP -> AM projection -> stable sort by projection residual ->
  controls -> noisy rollouts (K4) -> obstacle risk -> keep the
  ellite_num_cost lowest risks -> lane risk -> scalar cost -> elites ->
  CEM update.

``mmd_opt`` rolls R^2 mother rollouts per candidate, refits them, and
picks a weighted reduced set of R with the inner beta-CEM (K1, K2, or K3
and K2 under the fused selection) before the MMD risks.  The other modes
roll R rollouts per candidate: ``mmd_random`` scores them by MMD with
uniform weights 1/R and bandwidth 0.01 and no lane risk, ``cvar`` and
``saa`` by CVaR and by the violation fraction.

The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
that leaves every value on the device (no host synchronisation inside a
solve).  Every sort is stable, as ``jnp.argsort`` is.  The loop
(``SolverSetup._outer_cem``) carries a leading scenario axis: ``solve`` is
a chunk of one, and ``solve_batch`` runs ``scenario_chunk`` scenarios
through it at once, as the JAX package's ``lax.map(..., batch_size=)``
vmaps the solve over a chunk, so each kernel launch serves the chunk.  It
is shared with the on-road solve (``solver_frenet.py``, always a chunk of
one); each solver supplies the hooks that differ.

The "exact" strategy (``cfg.solve_strategy``) is the JAX package's
reference-parity path: KKT systems solved by LU, and the per-candidate
inner CEM of ``reduced_set.select_reduced_set``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import risk as risk_mod
from .config import ProblemConfig
from .device import resolve_device
from .dynamics import beta_parameters, controls_from_trajectory, perturb_controls
from .noise import TorchNoise, chunk_cem_z, chunk_rollout_beta, chunk_rollout_eps
from .ops import fused_rollout
from .projection import project
from .qp import (Workspace, boundary_vectors, build_workspace, compute_guess,
                 refit_coefficients)
from .reduced_set import ReducedSet, select_reduced_set, select_reduced_set_batched
from .sampling import cem_update, initial_params, scalar_cost


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


def noisy_controls(cfg: ProblemConfig, noise, seeds, it: int,
                   acc_T: torch.Tensor, steer_T: torch.Tensor):
    """R noisy variants (N, C, R, T) of the controls (N, C, T) of a chunk's
    candidates, each scenario from its seed's draws of the iteration (see
    :mod:`mpc_mmd_tpu_torch.noise`)."""
    R, T = cfg.risk.num_reduced, acc_T.shape[-1]
    d_acc, d_steer, eps_const = (e[:, None] for e in
                                 chunk_rollout_eps(noise, seeds, it, R, T))
    if cfg.noise.kind == "beta":
        d_acc, d_steer = chunk_rollout_beta(
            noise, seeds, it, R, *beta_parameters(acc_T, steer_T, cfg.noise))
    return perturb_controls(acc_T, steer_T, d_acc, d_steer, eps_const,
                            cfg.noise)


def batched_rollouts(cfg: ProblemConfig, a_n: torch.Tensor, s_n: torch.Tensor,
                     state0: torch.Tensor, mother: bool):
    """Rollouts of every candidate as one flat-lane rollout call (K4).

    a_n, s_n: the (..., C, R, T) noisy controls.  With ``mother``, row m
    pairs acc draw m // R with steer draw m % R, giving n = R^2 rollouts
    per candidate; else n = R.  state0 is (5,), shared by every rollout,
    or (n, 5): rollout m of every candidate starts from state m (the
    Frenet solve's noisy initial states), and K4 takes a state per lane.
    Returns x, y of shape (..., C, n, T).
    """
    R, T = a_n.shape[-2:]
    if mother:
        a_n = torch.repeat_interleave(a_n, R, dim=-2)
        s_n = s_n.repeat(*(1,) * (s_n.dim() - 2), R, 1)
    lead, n = a_n.shape[:-2], a_n.shape[-2]
    if state0.dim() == 2:
        state0 = state0.expand(*lead, n, 5).reshape(-1, 5)
    x, y = fused_rollout(a_n.reshape(-1, T), s_n.reshape(-1, T), state0,
                         cfg.horizon.dt, cfg.vehicle.wheel_base)
    return x.reshape(*lead, n, T), y.reshape(*lead, n, T)


def select_reduced(cfg: ProblemConfig, ws: Workspace, xr: torch.Tensor,
                   yr: torch.Tensor, inner) -> ReducedSet:
    """The mother rollouts (N, C, M, T) of a chunk refitted and reduced,
    every candidate of every scenario in one inner CEM; the reduced set's
    fields come back as (N, C, ...)."""
    lead, (M, T) = xr.shape[:-2], xr.shape[-2:]
    nvar = cfg.horizon.nvar
    cxr, cyr = refit_coefficients(ws, xr.reshape(-1, T), yr.reshape(-1, T),
                                  xr.shape[0])
    flat = (cxr.reshape(-1, M, nvar), cyr.reshape(-1, M, nvar),
            xr.reshape(-1, M, T), yr.reshape(-1, M, T), inner)
    rs = (select_reduced_set(cfg, *flat) if cfg.solve_strategy == "exact"
          else select_reduced_set_batched(cfg, *flat))
    return ReducedSet(*(f.reshape(*lead, *f.shape[1:]) for f in rs))


MODES = ("mmd_opt", "mmd_random", "cvar", "saa")
STRATEGIES = ("prefactored", "exact")

# the projection's values of every candidate that the outer loop sorts, by
# the names the loop's dicts give them
_CANDIDATE = (("y", "y"), ("xdot", "xdot"), ("ydot", "ydot"), ("xddot", "xddot"),
              ("yddot", "yddot"), ("cx", "c_x"), ("cy", "c_y"),
              ("res_norm", "res_norm"))


class SolverSetup:
    """What a solver builds once: the checked configuration, its device,
    the workspace, the noise source and the solver-fixed draws (the initial
    parameter batch and, in ``mmd_opt``, the inner CEM's); and the outer
    CEM loop (``_outer_cem``) that both solvers run through their hooks."""

    # the names of the kept candidates' values a solve returns of its best
    BEST: tuple = ()

    def __init__(self, cfg: ProblemConfig, device, noise, ws: Optional[Workspace],
                 modes):
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
            noise = TorchNoise(torch.Generator(device=self.device), self.device)
        self.noise = noise
        c, bc = cfg.cem, cfg.beta_cem
        self._z0 = noise.initial_z(c.num_batch, c.num_params)
        if cfg.risk.mode == "mmd_opt":
            draw = noise.inner_exact if cfg.solve_strategy == "exact" else noise.inner_cem
            self._inner = draw(bc.num_samples_cem, cfg.risk.num_mother,
                               bc.num_ellite, bc.maxiter)

    def _tensor(self, a) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = np.array(a, dtype=np.float32)   # a copy: inputs stay untouched
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _outer_cem(self, seeds, ctx, b_eq_x, b_eq_y, mean, cov, x_obs,
                   y_obs, v_des):
        """The outer CEM loop over a chunk of N scenarios, one iteration as
        the module docstring lists it, every step on all N at once.

        ``seeds`` the N scenarios' ``idx_mpc``; b_eq_x, b_eq_y (nb, .), mean
        (8,) and cov (8, 8) shared by the chunk; x_obs, y_obs (N, num_obs,
        num); ``ctx`` is what the hooks read of the solve (the rollouts'
        initial state, the path).  The projection runs on the chunk's N nb
        candidates as rows, scenario after scenario; everything after it
        on (N, nb, ...), every sort a stable argsort along the candidate
        axis and every gather per scenario.  Returns the last iteration's
        best candidate {name: (N, ...)} for the names in ``BEST``, the best
        cost and its projection residual of every iteration (N,
        maxiter_cem), and the final CEM moments (N, 8), (N, 8, 8).

        The subclass's hooks:

        * ``_project_kwargs(ctx)``: the projection's keyword arguments;
        * ``_steering(ctx, pr, take, steer)``: the candidates' values that
          depend on the path, "steer" (N, nb, num) among them, from the
          projection ``pr`` (rows), ``take`` (a row tensor in residual
          order, (N, nb, ...)) and the controls' steer;
        * ``_risks(ctx, it, seeds, acc_T, steer_T, x_obs_T, y_obs_T)``: the
          obstacle risk (N, nb) and {name: (N, nb, ...)} the cost reads;
        * ``_cost(kept, v_des)``: the scalar cost (N, n_cost) of the
          candidates kept by risk, from the dict of their values, to which
          it adds the lane risks it computes.
        """
        cfg, ws, noise = self.cfg, self.ws, self.noise
        N = len(seeds)
        nb, nvar, T = cfg.cem.num_batch, cfg.horizon.nvar, cfg.horizon.num_prime
        n_cost, n_el = cfg.cem.ellite_num_cost, cfg.cem.ellite_num
        rows = N * nb
        x_obs_T, y_obs_T = x_obs[:, None, :, :T], y_obs[:, None, :, :T]
        project_kw = self._project_kwargs(ctx)
        b_eq_x, b_eq_y = b_eq_x.repeat(N, 1), b_eq_y.repeat(N, 1)
        params = initial_params(cfg, mean, cov, self._z0).expand(N, nb, -1)
        mean, cov = mean.expand(N, -1), cov.expand(N, -1, -1)

        n_ix = torch.arange(N, device=self.device)
        per = n_ix[:, None]

        def take(t, idx):
            """t (N, n, ...) at the per-scenario indices idx (N, m)."""
            return t[per, idx]

        zeros = lambda *s: torch.zeros(s, device=self.device)
        lamda_x, lamda_y = zeros(rows, nvar), zeros(rows, nvar)
        s_lane = zeros(rows, 2 * (cfg.horizon.num - 1))
        res, res_2 = zeros(N, cfg.cem.maxiter_cem), zeros(N, cfg.cem.maxiter_cem)

        for it in range(cfg.cem.maxiter_cem):
            cx_bar, cy_bar = compute_guess(cfg, ws, params.reshape(rows, -1),
                                           b_eq_x, b_eq_y, N)
            pr = project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y, lamda_x,
                         lamda_y, s_lane, x_obs, y_obs, **project_kw)

            order = torch.argsort(pr.res_norm.reshape(N, nb), dim=1, stable=True)
            in_order = lambda t: take(t.reshape(N, nb, *t.shape[1:]), order)
            cand = {name: in_order(getattr(pr, field)) for name, field in _CANDIDATE}
            cand["params"] = take(params, order)
            acc, steer = controls_from_trajectory(
                cand["xdot"], cand["ydot"], cand["xddot"], cand["yddot"],
                cfg.horizon.dt, cfg.vehicle.wheel_base)
            cand.update(self._steering(ctx, pr, in_order, steer))
            acc_T = acc[..., :T].contiguous()
            steer_T = cand["steer"][..., :T].contiguous()

            risk_obs, per_cand = self._risks(ctx, it, seeds, acc_T, steer_T,
                                             x_obs_T, y_obs_T)

            order2 = torch.argsort(risk_obs, dim=1, stable=True)[:, :n_cost]
            kept = {name: take(t, order2) for name, t in (
                ("risk_obs", risk_obs), *cand.items(), *per_cand.items())}
            cost_batch = self._cost(kept, v_des)

            elite_idx = torch.argsort(cost_batch, dim=1, stable=True)[:, :n_el]
            cost_elite = torch.gather(cost_batch, 1, elite_idx)
            cem_z = chunk_cem_z(noise, seeds, it, nb - n_el, cfg.cem.num_params)
            mean, cov, params = cem_update(cfg, cem_z, take(kept["params"], elite_idx),
                                           cost_elite, mean, cov)

            # The reference's final-selection quirk: the argmin over the
            # SORTED elite costs (so 0) indexes the risk-sorted arrays.
            idx_min = torch.argmin(cost_elite, dim=1)
            res[:, it] = torch.amin(cost_elite, dim=1)
            res_2[:, it] = kept["res_norm"][n_ix, idx_min]
            best = {name: kept[name][n_ix, idx_min] for name in self.BEST}
            lamda_x, lamda_y, s_lane = pr.lamda_x, pr.lamda_y, pr.s_lane
        return best, res, res_2, mean, cov


class Solver(SolverSetup):
    """Builds the workspace and the fixed draws once; ``solve`` runs one MPC
    solve on ``device``, ``solve_batch`` many.

    Usage::

        solver = Solver(dynamic_workload(mode="cvar"))      # on the card
        result = solver.solve(seed, init_state, mean, cov, x_obs, y_obs, v_des)
        cpu_solver = Solver(cfg, device="cpu")              # plain twins

    ``device`` defaults to ``"cuda"``; without a card that raises a
    ``RuntimeError`` naming ``device="cpu"``, the only way onto the CPU.
    ``noise`` defaults to :class:`TorchNoise` on ``device``.  On a CUDA
    device the rollouts, top-k selections, fused selections and weight QPs
    run the hand-written kernels (``ops``); on the CPU their plain twins.
    ``cfg.solve_strategy`` "exact" runs the reference-parity inner CEM
    (``reduced_set.select_reduced_set``) and KKT solves; only K4 of the
    kernels is on its path.  ``scenario_chunk`` (default
    ``MPC_MMD_SCENARIO_CHUNK``, else 1) is how many scenarios
    ``solve_batch`` runs at once: one outer loop over a leading scenario
    axis, every kernel launched once for the whole chunk.
    """

    def __init__(self, cfg: ProblemConfig, device="cuda", noise=None,
                 ws: Optional[Workspace] = None,
                 scenario_chunk: Optional[int] = None):
        if scenario_chunk is None:
            scenario_chunk = int(os.environ.get("MPC_MMD_SCENARIO_CHUNK", "1"))
        self.scenario_chunk = max(1, scenario_chunk)
        super().__init__(cfg, device, noise, ws, MODES)

    BEST = ("cx", "cy", "risk_lane", "risk_obs", "beta", "sigma", "res_beta")

    def _project_kwargs(self, state0):
        return {}

    def _steering(self, state0, pr, in_order, steer):
        return {"steer": steer}

    def _risks(self, state0, it, seeds, acc_T, steer_T, x_obs_T, y_obs_T):
        """Obstacle risk (N, C) and, per candidate, the rollouts the lane
        risk reads (N, C, R, T), beta (N, C, R), sigma (N, C) and the inner
        residuals (N, C, maxiter)."""
        cfg = self.cfg
        mode = cfg.risk.mode
        lead = acc_T.shape[:-1]
        a_n, s_n = noisy_controls(cfg, self.noise, seeds, it, acc_T, steer_T)
        xr, yr = batched_rollouts(cfg, a_n, s_n, state0,
                                  mother=mode == "mmd_opt")
        if mode == "mmd_opt":
            rs = select_reduced(cfg, self.ws, xr, yr, self._inner)
            risk_obs = risk_mod.mmd_obs(cfg, rs.beta, rs.sigma, rs.x_red,
                                        rs.y_red, x_obs_T, y_obs_T)
            return risk_obs, dict(roll=rs.y_red, beta=rs.beta, sigma=rs.sigma,
                                  res_beta=rs.res)
        R = cfg.risk.num_reduced
        beta = torch.full(lead + (R,), 1.0 / R, device=self.device)
        sigma = torch.full(lead, 0.01, device=self.device)
        res_beta = torch.zeros(lead + (cfg.beta_cem.maxiter,), device=self.device)
        if mode == "mmd_random":
            risk_obs = risk_mod.mmd_obs(cfg, beta, sigma, xr, yr, x_obs_T,
                                        y_obs_T)
        elif mode == "cvar":
            risk_obs = risk_mod.cvar_obs(cfg, xr, yr, x_obs_T, y_obs_T)
        else:
            risk_obs = risk_mod.saa_obs(cfg, xr, yr, x_obs_T, y_obs_T)
        return risk_obs, dict(roll=yr, beta=beta, sigma=sigma, res_beta=res_beta)

    def _lane_risk(self, beta_e, sigma_e, y_roll_e):
        cfg = self.cfg
        mode = cfg.risk.mode
        if mode == "mmd_opt":
            return risk_mod.mmd_lane(cfg, beta_e, sigma_e, y_roll_e)
        if mode == "mmd_random":
            # the reference zeroes the lane risk on the random path
            return torch.zeros(sigma_e.shape, device=self.device)
        if mode == "cvar":
            return risk_mod.cvar_lane(cfg, y_roll_e)
        return risk_mod.saa_lane(cfg, y_roll_e)

    def _cost(self, k, v_des):
        w_lane, w_obs = self.cfg.risk.weights()
        k["risk_lane"] = self._lane_risk(k["beta"], k["sigma"], k["roll"])
        return scalar_cost(self.cfg, w_obs * k["risk_obs"], w_lane * k["risk_lane"],
                           k["y"], k["res_norm"], k["xdot"], k["ydot"],
                           k["xddot"], k["yddot"], k["steer"], v_des)

    def _solve_chunk(self, seeds, init_state, mean_param, cov_param,
                     x_obs_trajs, y_obs_trajs, v_des) -> SolveResult:
        """The scenarios ``seeds`` in one outer loop; every field (N, ...)."""
        init_state = self._tensor(init_state)
        b_eq_x, b_eq_y = boundary_vectors(self.cfg, init_state)
        state0 = torch.stack((init_state[0], init_state[1], init_state[2],
                              init_state[3],
                              torch.atan2(init_state[3], init_state[2])))
        best, res, res_2, mean, cov = self._outer_cem(
            [int(s) for s in seeds], state0, b_eq_x, b_eq_y,
            self._tensor(mean_param), self._tensor(cov_param),
            self._tensor(x_obs_trajs), self._tensor(y_obs_trajs), v_des)
        return SolveResult(**best, res=res, res_2=res_2, mean_param=mean,
                           cov_param=cov)

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
                              self._tensor(x_obs_traj)[None],
                              self._tensor(y_obs_traj)[None], v_des)
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
        xs, ys = self._tensor(x_obs_trajs), self._tensor(y_obs_trajs)
        c = self.scenario_chunk
        parts = [self._solve_chunk(seeds[lo:lo + c], init_state, mean_param,
                                   cov_param, xs[lo:lo + c], ys[lo:lo + c], v_des)
                 for lo in range(0, len(seeds), c)]
        return SolveResult(*(torch.cat(f) for f in zip(*parts)))
