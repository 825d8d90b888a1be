# Frozen copy of mpc_mmd_tpu_torch/solver_frenet.py (commit eb91b04) cut to the path
# the cells run (mmd_opt, prefactored, Gaussian noise, eager): every
# hand-written kernel call taken out, so this runs PyTorch operations on
# any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""The on-road solver: the outer CEM in the Frenet frame of a local path.

Counterpart of ``mpc_mmd_tpu/solver_frenet.py`` in the ``mmd_opt`` mode.
What differs from the straight-road solve (``solver.py``):

* n noisy initial states, (x, y) perturbed by the solve's ``init_z`` (n is
  ``init_state_count``), and the equality boundary conditions from the
  mean of their Frenet states (kernel (g)'s state form);
* the projection in the Frenet frame, with the curvature-coupled steering
  as the candidates' steer (kernel (d) computes both);
* rollouts in the GLOBAL frame, lane m of every candidate from state m
  (K4n with a state per lane), converted pointwise to Frenet for the risks
  (kernel (g));
* the scalar cost gains the centripetal-acceleration and desired-lane
  terms (``sampling.frenet_scalar_cost``; kernel (e));
* the result carries the best candidate's speed and steering profiles
  and the final CEM moments (``mean_param`` warm-starts the next step).

The outer loop is ``solver.py``'s (``SolverSetup._outer_cem``), at N = 1
(the JAX ``FrenetSolver`` has no ``solve_batch``); this module supplies
its hooks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import ProblemConfig
from .frenet import FrenetFrame, global_to_frenet_points, initial_states
from .noise import init_state_count
from .solver import SolverSetup, select_reduced


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
    one on-road MPC solve on ``device``, eagerly.

    Usage::

        solver = FrenetSolver(cfg, device="cuda")
        r = solver.solve(idx_mpc, init_state_global, mean, cov,
                         x_obs_traj, y_obs_traj, v_des, frame)
    """

    def __init__(self, cfg: ProblemConfig, device="cuda"):
        super().__init__(cfg, device)

    def _initial_states(self, frame: FrenetFrame, z: torch.Tensor,
                        init_state_global: torch.Tensor):
        """The noisy initial states (n, 5) [x, y, vx, vy, psi] from the
        standard normals ``z`` (n, 4) the solve's draws took from the
        ``init_key``, and the Frenet boundary rows (b_eq_x, b_eq_y) from the
        mean of their Frenet states (kernel (g)'s state form's stage,
        ``frenet.initial_states``)."""
        cfg = self.cfg
        return initial_states(frame, z, init_state_global, cfg.frenet.init_mu,
                             cfg.frenet.init_sigma, cfg.cem.num_batch)

    BEST = ("cx", "cy", "steer", "risk_obs")
    FRENET = True

    def _path(self, ctx):
        frame, _ = ctx
        return dict(arc_vec=frame.arc_vec, kappa=frame.kappa)

    def _ensemble(self, ctx, eps, acc_T, steer_T):
        """The Frenet points of the candidates' reduced rollouts {"x": s,
        "roll": l (N, C, R, T)}, beta (N, C, R) and sigma (N, C): the
        reduced sets of R^2 mother rollouts, converted as kernel (g) does
        (``frenet.global_to_frenet_points``)."""
        frame, states0 = ctx
        xg, yg = self._rollouts(eps, acc_T, steer_T, states0)
        rs = select_reduced(self.cfg, self.ws, xg, yg, self._inner_fixed)
        s_roll, l_roll = global_to_frenet_points(frame, rs.x_red, rs.y_red)
        return dict(x=s_roll, roll=l_roll, beta=rs.beta, sigma=rs.sigma)

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
