# Frozen copy of mpc_mmd_tpu_torch/solver.py (commit eb91b04) cut to the path
# the cells run (mmd_opt, prefactored, Gaussian noise, eager): every
# hand-written kernel call taken out, so this runs PyTorch operations on
# any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Outer CEM solver: the risk-aware MPC solve in the ``mmd_opt`` mode.

Counterpart of ``mpc_mmd_tpu/solver.py``.  One outer iteration:

  guess QP -> AM projection -> controls (kernel (d)) -> stable sort by
  projection residual -> noisy rollouts (K4n) -> refit and distance
  matrices (kernel (f)) -> inner beta-CEM (kernel (c)) -> obstacle risk ->
  keep the ellite_num_cost lowest risks -> lane risk -> scalar cost ->
  elites -> CEM update (kernel (e)).

``mmd_opt`` rolls R^2 mother rollouts per candidate, refits them and
takes their distance matrices, and picks a weighted reduced set of R with
the inner beta-CEM before the MMD risks.  The JAX package runs the loop as
one ``lax.scan``; here a solve is a host prologue, which turns the
arguments into named input tensors (the key table of the chunk's draws,
the initial state, the CEM moments, the obstacles, ``v_des``), and a body,
a Python loop over the outer iterations, run eagerly.  Every sort is
stable, as ``jnp.argsort`` is.  The loop (``SolverSetup._outer_cem``)
carries a leading scenario axis: ``solve`` is a chunk of one, and
``solve_batch`` runs ``scenario_chunk`` scenarios through it at once, as
the JAX package's ``lax.map(..., batch_size=)`` does.  It is shared with
the on-road solve (``solver_frenet.py``, a chunk of one); each solver
supplies the hooks that differ.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .config import ProblemConfig
from .device import resolve_device, to_device
from .noise import JaxNoise
from .inner_prologue import inner_prologue
from .outer_project import outer_project
from .outer_tail import outer_tail
from .qp import Workspace, boundary_vectors, build_workspace
from .reduced_set import ReducedSet, inner_fixed, select_reduced_set_batched
from .rollout import noisy_rollout
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


def select_reduced(cfg: ProblemConfig, ws: Workspace, xr: torch.Tensor,
                   yr: torch.Tensor, fixed) -> ReducedSet:
    """The mother rollouts (N, C, M, T) of a chunk refitted and reduced,
    every candidate of every scenario in one inner CEM; the reduced set's
    fields come back as (N, C, ...).  The refit and the distance matrices
    are kernel (f)'s stage (``inner_prologue``); ``fixed``: the hoisted
    ``reduced_set.inner_fixed`` of the inner CEM's draws."""
    lead, (M, T) = xr.shape[:-2], xr.shape[-2:]
    pro = inner_prologue(ws, xr, yr, cfg.risk.kernel)
    rs = select_reduced_set_batched(cfg, xr.reshape(-1, M, T), yr.reshape(-1, M, T), fixed,
                                    (pro.D, pro.D2))
    return ReducedSet(*(f.reshape(*lead, *f.shape[1:]) for f in rs))


class SolverSetup:
    """What a solver builds once: the checked configuration, its device,
    the workspace, the noise source and the solver-fixed draws (the initial
    parameter batch and the inner CEM's); the outer CEM loop
    (``_outer_cem``) that both solvers run through their hooks; and
    :meth:`_run`, which runs a solve's body."""

    # the names of the kept candidates' values a solve returns of its best
    BEST: tuple = ()
    # the on-road cost (sampling.candidate_cost) and the projection's steering
    FRENET = False

    def __init__(self, cfg: ProblemConfig, device):
        if (cfg.risk.mode, cfg.solve_strategy, cfg.noise.kind) != (
                "mmd_opt", "prefactored", "gaussian"):
            raise NotImplementedError(
                "the reference runs mmd_opt, prefactored, Gaussian noise: got "
                f"{cfg.risk.mode!r}, {cfg.solve_strategy!r}, {cfg.noise.kind!r}")
        if cfg.cem.maxiter_cem < 1 or cfg.beta_cem.maxiter < 1:
            raise ValueError("maxiter_cem and beta_cem.maxiter must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ws = build_workspace(cfg, self.device)
        self.noise = JaxNoise(self.device)

    def _picked(self, ens, n_ix, pos):
        """The values beyond the trajectory and the risks that ``BEST``
        names, of the pick ``pos`` (N,) of scenarios ``n_ix`` in the last
        iteration's ensemble ``ens``: none."""
        return {}

    # the solver-fixed draws
    @functools.cached_property
    def _z0(self) -> torch.Tensor:
        c = self.cfg.cem
        return self.noise.initial_z(c.num_batch, c.num_params)

    @functools.cached_property
    def _inner_fixed(self):
        """The inner CEM's first batch and affine resample coefficients
        (``reduced_set.inner_fixed``) of the solver-fixed draws."""
        cfg, bc = self.cfg, self.cfg.beta_cem
        return inner_fixed(cfg, self.noise.inner_cem(
            bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite, bc.maxiter))

    def _rollouts(self, eps, acc_T, steer_T, state0):
        """The R^2 noisy mother rollouts x, y (N, C, R^2, T) of the controls
        (N, C, T) from the iteration's rollout normals ``eps`` (eps_acc,
        eps_steer, eps_const; each (N, R, T)) and the initial state(s)
        ``state0`` (K4n)."""
        cfg = self.cfg
        return noisy_rollout(acc_T, steer_T, *(e[:, None] for e in eps), state0,
                             cfg.noise, cfg.horizon.dt, cfg.vehicle.wheel_base, True)

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
        """A solve's body on its named inputs moved to the device."""
        return body(**{k: to_device(t, self.device) for k, t in inputs.items()})

    def _draws(self, keys, init=None):
        """The solve's Gaussian draws, every outer iteration's at once, from
        the key table ``keys`` (N, maxiter_cem, ...) on the device
        (``noise.JaxNoise.solve_draws``): the rollout normals, the outer
        CEM's resample and, given ``init`` = (init_key, n), the noisy
        initial states'."""
        cfg, c = self.cfg, self.cfg.cem
        return self.noise.solve_draws(keys, cfg.risk.num_reduced, cfg.horizon.num_prime,
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
        scenario.  Returns the last iteration's best candidate {name: (N, ...)}
        for the names in ``BEST``, the best cost and its projection residual
        of every iteration (N, maxiter_cem), and the final CEM moments (N,
        8), (N, 8, 8).

        The subclass's hooks:

        * ``_path(ctx)``: the path's arc_vec and kappa as keyword
          arguments of the projection, or none;
        * ``_ensemble(ctx, eps, acc_T, steer_T)``: the candidates' reduced
          rollouts {"x", "roll": (N, nb, R, T), "beta": (N, nb, R), "sigma":
          (N, nb), ...} from the iteration's rollout normals ``eps``, which
          the tail scores;
        * ``_picked(ens, n_ix, pos)``: the pick's values of the last
          ensemble that ``BEST`` names.
        """
        cfg, ws = self.cfg, self.ws
        N = keys.shape[0]
        nb, nvar, T = cfg.cem.num_batch, cfg.horizon.nvar, cfg.horizon.num_prime
        rows = N * nb
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
            pj = outer_project(cfg, ws, params.reshape(rows, -1), b_eq_x, b_eq_y, lamda_x,
                         lamda_y, s_lane, x_obs, y_obs, **path)
            order = torch.argsort(pj.res_norm.reshape(N, nb), dim=1, stable=True)
            in_order = lambda t: t.reshape(N, nb, *t.shape[1:])[per, order]
            steer = pj.steering if self.FRENET else pj.steer
            acc_T, steer_T = in_order(pj.acc[:, :T]), in_order(steer[:, :T])

            ens = self._ensemble(ctx, draws.eps[it], acc_T, steer_T)
            tail = outer_tail(cfg, self.FRENET, pj, order, params, ens["beta"],
                              ens["sigma"], ens["x"], ens["roll"], x_obs, y_obs,
                              draws.cem_z[it], mean, cov, v_des, res, res_2, it)
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
    solve on ``device``, ``solve_batch`` many, eagerly.  ``noise`` is
    :class:`JaxNoise` on ``device``: the JAX package's draws for the same
    ``idx_mpc``.  ``scenario_chunk`` (default 1) is how many scenarios
    ``solve_batch`` runs at once: one outer loop over a leading scenario
    axis."""

    def __init__(self, cfg: ProblemConfig, device="cuda",
                 scenario_chunk: Optional[int] = None):
        self.scenario_chunk = max(1, scenario_chunk or 1)
        super().__init__(cfg, device)

    BEST = ("cx", "cy", "risk_lane", "risk_obs", "beta", "sigma", "res_beta")

    def _path(self, state0):
        return {}

    def _ensemble(self, state0, eps, acc_T, steer_T):
        """The R^2 mother rollouts of the noisy controls (N, C, T) reduced to
        R: {"x", "roll": (N, C, R, T), "beta": (N, C, R), "sigma": (N, C),
        "res_beta": the inner residuals (N, C, maxiter)}."""
        xr, yr = self._rollouts(eps, acc_T, steer_T, state0)
        rs = select_reduced(self.cfg, self.ws, xr, yr, self._inner_fixed)
        return dict(x=rs.x_red, roll=rs.y_red, beta=rs.beta, sigma=rs.sigma,
                    res_beta=rs.res)

    def _picked(self, ens, n_ix, pos):
        """The pick's beta (N, R), sigma (N,) and inner residuals (N,
        maxiter)."""
        return {name: ens[name][n_ix, pos] for name in ("beta", "sigma", "res_beta")}

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
