"""The on-road solver: the outer CEM in the Frenet frame of a local path.

Counterpart of ``mpc_mmd_tpu/solver_frenet.py``.  What differs from the
straight-road solve (``solver.py``):

* n noisy initial states, (x, y) perturbed from ``init_state_z`` (see
  :mod:`mpc_mmd_tpu_torch.noise`; n is ``init_state_count``), and the
  equality boundary conditions from the mean of their Frenet states (kernel
  (g)'s state form, one launch a solve);
* the projection in the Frenet frame, with the curvature-coupled steering
  as the candidates' steer (kernel (d) computes both);
* rollouts in the GLOBAL frame, lane m of every candidate from state m
  (K4n with a state per lane), converted pointwise to Frenet for the risks
  (kernel (g));
* the scalar cost gains the centripetal-acceleration and desired-lane
  terms (``sampling.frenet_scalar_cost``; kernel (e) in every mode), and
  ``mmd_random`` keeps its lane risk;
* ``det`` runs the obstacle-active projection (``with_obstacle_terms`` is
  forced on; kernel (d)'s obstacle-active form), one initial state and no
  rollout, with every risk zero (kernel (e)'s ``det`` form);
* the result carries the best candidate's speed and steering profiles
  and the final CEM moments (``mean_param`` warm-starts the next step).

The outer loop is ``solver.py``'s (``SolverSetup._outer_cem``): Python
over outer iterations, with no host synchronisation inside a solve and
every sort stable, and on the card captured with the noisy initial states
in one CUDA graph whose inputs include the frame's tensors (``graph.py``);
this module supplies its hooks, which take the loop's leading scenario
axis and run at N = 1 (the JAX ``FrenetSolver`` has no ``solve_batch``).
The "exact" strategy runs the reference-parity inner CEM and KKT solves,
as in ``solver.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import risk
from .config import ProblemConfig
from .frenet import FrenetFrame, global_to_frenet_points, initial_states
from .noise import init_state_count
from .ops import frenet_points, frenet_states
from .ops.outer_tail import filled
from .qp import Workspace
from .solver import MODES, SolverSetup, select_reduced

FRENET_MODES = MODES + ("det",)


class FrenetSolveResult(NamedTuple):
    cx: torch.Tensor             # (nvar,)
    cy: torch.Tensor
    v_best: torch.Tensor         # (num,) speed profile of the best candidate
    steering_best: torch.Tensor  # (num,) its curvature-coupled steering
    mean_param: torch.Tensor     # (8,)
    cov_param: torch.Tensor      # (8, 8)
    res: torch.Tensor            # (maxiter_cem,) best scalar cost per iteration
    risk_obs: torch.Tensor       # ()


class FrenetSolver(SolverSetup):
    """Builds the workspace and the solver-fixed draws once; ``solve`` runs
    one on-road MPC solve on ``device``.

    Usage::

        solver = FrenetSolver(onroad_workload(mode="cvar"))   # on the card
        r = solver.solve(idx_mpc, init_state_global, mean, cov,
                         x_obs_traj, y_obs_traj, v_des, frame)

    Modes ``mmd_opt``, ``mmd_random``, ``cvar``, ``saa`` and ``det``, the
    "prefactored" and "exact" strategies, and the selections of
    :class:`mpc_mmd_tpu_torch.solver.Solver`.  ``device`` defaults to
    ``"cuda"`` and raises without a card; pass ``device="cpu"`` for the CPU.
    On the card a solve is one CUDA graph replay per frame shape
    (``graph``: see :class:`~mpc_mmd_tpu_torch.solver.SolverSetup`);
    ``graph=False`` runs it eagerly.
    """

    def __init__(self, cfg: ProblemConfig, device="cuda", noise=None,
                 ws: Optional[Workspace] = None, graph: Optional[bool] = None):
        if cfg.risk.mode == "det" and not cfg.projection.with_obstacle_terms:
            cfg = cfg.replace(projection=dataclasses.replace(
                cfg.projection, with_obstacle_terms=True))
        super().__init__(cfg, device, noise, ws, FRENET_MODES, graph)

    def _initial_states(self, frame: FrenetFrame, z: torch.Tensor,
                        init_state_global: torch.Tensor):
        """The noisy initial states (n, 5) [x, y, vx, vy, psi] from the
        standard normals ``z`` (n, 4) the solve's ``solve_draws`` drew from
        the noise source's ``init_key``, and the Frenet boundary rows
        (b_eq_x, b_eq_y) from the mean of their Frenet states: kernel (g)'s
        state form (``ops.frenet_states``) where ``_glue_routes`` sends
        them, else its plain version ``frenet.initial_states``."""
        cfg = self.cfg
        convert = frenet_states if self._glue_routes().frenet_states else initial_states
        return convert(frame, z, init_state_global, cfg.frenet.init_mu,
                       cfg.frenet.init_sigma, cfg.cem.num_batch)

    BEST = ("cx", "cy", "steer", "risk_obs")
    FRENET = True

    def _path(self, ctx):
        frame, _ = ctx
        return dict(arc_vec=frame.arc_vec, kappa=frame.kappa)

    def _ensemble(self, ctx, step, acc_T, steer_T):
        """The Frenet points of the candidates' rollouts {"x": s, "roll": l
        (N, C, R, T)}, beta (N, C, R) and sigma (N, C): in ``mmd_opt`` the
        reduced sets of R^2 mother rollouts, in ``mmd_random`` R rollouts
        with the uniform weights (``risk.uniform_weights``), in ``cvar`` and
        ``saa`` R rollouts and no weights (None), in ``det`` nothing (None:
        kernel (e) reads none)."""
        frame, states0 = ctx
        cfg = self.cfg
        mode = cfg.risk.mode
        if mode == "det":
            return dict(x=None, roll=None, beta=None, sigma=None)
        beta = sigma = None
        mother = mode == "mmd_opt"
        routes = self._glue_routes()
        xg, yg = self._rollouts(step, acc_T, steer_T, states0, mother)
        if mother:
            rs = select_reduced(cfg, self.ws, xg, yg, self._inner, self._inner_fixed,
                                routes.inner_prologue)
            xg, yg, beta, sigma = rs.x_red, rs.y_red, rs.beta, rs.sigma
        elif mode == "mmd_random":
            beta, sigma = risk.uniform_weights(cfg, acc_T.shape[:-1], self.device)
        convert = frenet_points if routes.frenet_points else global_to_frenet_points
        s_roll, l_roll = convert(frame, xg, yg)
        return dict(x=s_roll, roll=l_roll, beta=beta, sigma=sigma)

    def _risks(self, ctx, step, acc_T, steer_T, x_obs, y_obs):
        """Obstacle risk (N, C) and, per candidate, the Frenet lateral
        offsets of the rollouts the lane risks read (N, C, R, T), beta
        (N, C, R) and sigma (N, C), with what the chain reads where the mode
        reads nothing (``ops.outer_tail.filled``)."""
        e = self._ensemble(ctx, step, acc_T, steer_T)
        beta, sigma, x, roll = filled(self.cfg, acc_T.shape[:-1], self.device, e["beta"],
                                      e["sigma"], e["x"], e["roll"])
        return (risk.obstacle_risk(self.cfg, beta, sigma, x, roll, x_obs, y_obs),
                dict(roll=roll, beta=beta, sigma=sigma))

    @torch.no_grad()
    def solve(self, idx_mpc: int, init_state_global, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des, frame: FrenetFrame
              ) -> FrenetSolveResult:
        """One on-road solve; arguments as ``mpc_mmd_tpu.FrenetSolver.solve``.

        init_state_global (6,) = [x, y, v, vdot, psi, psidot] in the frame
        of ``frame``'s path; mean_param (8,), cov_param (8, 8);
        x_obs_traj, y_obs_traj (num_obs, num) the obstacles' Frenet
        trajectories (s, l); v_des a float; ``frame`` the path's
        :class:`~mpc_mmd_tpu_torch.frenet.FrenetFrame`.
        """
        return FrenetSolveResult(**self._run(
            self._body, keys=self.noise.keys([idx_mpc], self.cfg.cem.maxiter_cem),
            init_key=self.noise.init_key(idx_mpc),
            init_state=self._input(init_state_global), mean=self._input(mean_param),
            cov=self._input(cov_param), x_obs=self._input(x_obs_traj)[None],
            y_obs=self._input(y_obs_traj)[None], v_des=self._input(v_des),
            **{name: self._input(t) for name, t in zip(FrenetFrame._fields, frame)}))

    def _body(self, keys, init_key, init_state, mean, cov, x_obs, y_obs, v_des,
              **frame):
        """The device body of a solve: the solve's draws (one launch of
        kernel (a)'s plan form on the default noise, the noisy initial
        states' normals with them), the noisy initial states, the outer
        loop, the best candidate's speed profile; the frame's tensors come
        by their ``FrenetFrame`` names."""
        frame = FrenetFrame(**frame)
        draws = self._draws(keys, (init_key, init_state_count(self.cfg)))
        states0, b_eq_x, b_eq_y = self._initial_states(frame, draws.init_z, init_state)
        best, res, _, mean, cov = self._outer_cem(
            keys, draws, (frame, states0), b_eq_x, b_eq_y, mean, cov, x_obs, y_obs,
            v_des)
        best = {name: t[0] for name, t in best.items()}
        Pdot = self.ws.Pdot
        v_best = torch.sqrt((Pdot @ best["cx"]) ** 2 + (Pdot @ best["cy"]) ** 2)
        return dict(cx=best["cx"], cy=best["cy"], v_best=v_best,
                    steering_best=best["steer"], mean_param=mean[0],
                    cov_param=cov[0], res=res[0], risk_obs=best["risk_obs"])
