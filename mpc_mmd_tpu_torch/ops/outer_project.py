"""Kernel (d): the guess QP, the AM projection and the controls of every
candidate row in one launch (CUDA source ``csrc/outer_project.cu``), and
its plain version.

The JAX package runs this part of an outer iteration inside its jitted
``lax.scan`` (``mpc_mmd_tpu/solver.py:190-200``: ``compute_guess``,
``project`` and ``controls_from_trajectory``), which XLA fuses into a few
loops.  :func:`outer_project_plain` is the port's chain of PyTorch
operations for it (``qp.compute_guess``, ``projection.project``,
``dynamics.controls_from_trajectory``: about 240 launches an outer
iteration on the card); :func:`outer_project` runs all of it in one
launch, a warpgroup a row, one or two rows a CTA, at the path shapes'
compile-time instantiation or at the run-time-shape one
(:func:`launch_choice`).  The rows are independent: the controls of a row
computed before the outer loop's sort by residual are the ones it has
after it.

The kernel has two forms: the stochastic projection of every risk-aware
mode, and the obstacle-active one (``ProjectionConfig.with_obstacle_terms``:
the ``det`` baseline's, and the straight solver's when it is asked for),
which adds each obstacle block's polar step, residuals and multiplier
terms to every AM round.  On the card the solvers take the kernel under
the "prefactored" strategy; the "exact" strategy keeps the plain chain
(``solver.SolverSetup._routes``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build
from .. import dynamics, projection, qp
from ..config import ProblemConfig
from ..qp import Workspace

MAX_NUM = 128     # time steps: one a thread of a row's warpgroup
MAX_NVAR = 16     # Bernstein coefficients
MAX_SEGMENTS = 8  # guess segments (the parameters are 2 x segments wide)
# (nvar, num, segments) of the kernel's compile-time instantiation: every
# path's shape
COMPILED_SHAPE = (11, 100, 4)
# from this many rows on, two rows a CTA: one row a CTA is the faster at
# 64 and 100 rows, two at 256 and 512 (utils/kernel_ab.py on the H100)
TWO_ROWS_FROM = 200


def launch_choice(nvar: int, num: int, segments: int, rows: int, rows_per_cta: int = 0,
                  runtime_shape: bool = False):
    """(rows a CTA, compiled) of a launch of kernel (d): one row a CTA up
    to TWO_ROWS_FROM rows, else two, unless ``rows_per_cta`` (1 or 2; 0 the
    default) forces it; the compile-time instantiation at COMPILED_SHAPE
    unless ``runtime_shape`` asks for the run-time-shape one, which takes
    every shape within the limits."""
    if rows_per_cta not in (0, 1, 2):
        raise ValueError(f"outer_project: rows_per_cta is 0, 1 or 2, got {rows_per_cta}")
    compiled = not runtime_shape and (nvar, num, segments) == COMPILED_SHAPE
    return rows_per_cta or (1 if rows < TWO_ROWS_FROM else 2), compiled


class OuterProjection(NamedTuple):
    """The projection's fields (``projection.ProjectionResult``) and the
    controls of each row."""

    c_x: torch.Tensor        # (rows, nvar)
    c_y: torch.Tensor
    x: torch.Tensor          # (rows, num)
    y: torch.Tensor
    xdot: torch.Tensor
    ydot: torch.Tensor
    xddot: torch.Tensor
    yddot: torch.Tensor
    res_norm: torch.Tensor   # (rows,)
    lamda_x: torch.Tensor    # (rows, nvar)
    lamda_y: torch.Tensor
    s_lane: torch.Tensor     # (rows, 2 (num - 1))
    steering: torch.Tensor   # (rows, num) Frenet steering (zeros off the path)
    kappa_interp: torch.Tensor  # (rows, num)
    acc: torch.Tensor        # (rows, num) controls_from_trajectory's
    steer: torch.Tensor


def outer_project_plain(cfg: ProblemConfig, ws: Workspace, params: torch.Tensor,
                        b_eq_x: torch.Tensor, b_eq_y: torch.Tensor,
                        lamda_x: torch.Tensor, lamda_y: torch.Tensor,
                        s_lane: torch.Tensor, x_obs: Optional[torch.Tensor] = None,
                        y_obs: Optional[torch.Tensor] = None,
                        arc_vec: Optional[torch.Tensor] = None,
                        kappa: Optional[torch.Tensor] = None) -> OuterProjection:
    """Plain version: the guess QP, the projection and the controls as
    PyTorch operations, in any strategy and with the obstacle terms.
    Arguments and result as :func:`outer_project`."""
    scenarios = 1 if x_obs is None or x_obs.dim() == 2 else x_obs.shape[0]
    cx_bar, cy_bar = qp.compute_guess(cfg, ws, params, b_eq_x, b_eq_y, scenarios)
    pr = projection.project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y, lamda_x,
                            lamda_y, s_lane, x_obs, y_obs, arc_vec, kappa)
    acc, steer = dynamics.controls_from_trajectory(
        pr.xdot, pr.ydot, pr.xddot, pr.yddot, cfg.horizon.dt, cfg.vehicle.wheel_base)
    return OuterProjection(*pr, acc, steer)


def constants(cfg: ProblemConfig):
    """The kernel's float32 constants, rounded as the plain chain rounds
    them on the card: a Python float times a tensor is the float's float32;
    a tensor over a Python float is a product with the float32 reciprocal;
    the lane bounds are products of Python floats."""
    pj, veh, lane = cfg.projection, cfg.vehicle, cfg.lane
    f32 = lambda v: float(np.float32(v))
    return [f32(pj.rho_ineq), f32(pj.rho_projection), f32(pj.rho_lane),
            f32(pj.gamma * lane.y_ub), f32(-pj.gamma * lane.y_lb),
            f32(veh.v_min), f32(veh.v_max), f32(veh.a_max),
            float(np.float32(1.0) / np.float32(cfg.horizon.dt)),
            f32(veh.wheel_base)]


def obstacle_constants(cfg: ProblemConfig):
    """The obstacle-active form's float32 constants: rho_obs, a_obs,
    b_obs, a_obs^2 and b_obs^2 (products of Python floats), and 1 -
    gamma_obs."""
    pj, ob = cfg.projection, cfg.obstacles
    f32 = lambda v: float(np.float32(v))
    return [f32(pj.rho_obs), f32(ob.a_obs), f32(ob.b_obs), f32(ob.a_obs ** 2),
            f32(ob.b_obs ** 2), f32(1.0 - pj.gamma_obs)]


def _check(cfg: ProblemConfig, ws: Workspace, params, b_eq_x, b_eq_y, lamda_x,
           lamda_y, s_lane, arc_vec, kappa, x_obs=None, y_obs=None) -> int:
    """The number of rows; raises on arguments neither version takes."""
    h = cfg.horizon
    rows, nvar, num = params.shape[0], h.nvar, h.num
    want = {"params": (params, (rows, 2 * cfg.guess.num_segments)),
            "b_eq_x": (b_eq_x, (rows, 3)), "b_eq_y": (b_eq_y, (rows, 4)),
            "lamda_x": (lamda_x, (rows, nvar)), "lamda_y": (lamda_y, (rows, nvar)),
            "s_lane": (s_lane, (rows, 2 * (num - 1)))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"outer_project: {name} {tuple(t.shape)} must be {shape}")
    if (arc_vec is None) != (kappa is None) or (
            arc_vec is not None and (arc_vec.dim() != 1 or kappa.shape != arc_vec.shape
                                     or arc_vec.shape[0] < 2)):
        raise ValueError("outer_project: the path is arc_vec and kappa of one "
                         "length (at least 2), or neither")
    if ws.P.shape != (num, nvar):
        raise ValueError(f"outer_project: the workspace's P {tuple(ws.P.shape)} "
                         f"is not ({num}, {nvar})")
    if cfg.projection.with_obstacle_terms:
        ob = cfg.obstacles
        if x_obs is None or y_obs is None:
            raise ValueError("outer_project: the obstacle terms read x_obs and y_obs")
        n = 1 if x_obs.dim() == 2 else x_obs.shape[0]
        if (x_obs.shape[-2:] != (ob.num_obs * ob.num_circles, num)
                or y_obs.shape != x_obs.shape or x_obs.dim() not in (2, 3)
                or rows % n != 0):
            raise ValueError(f"outer_project: the obstacle terms take x_obs, y_obs "
                             f"(N, {ob.num_obs * ob.num_circles}, {num}) of N scenarios "
                             f"whose rows come one after another, got "
                             f"{tuple(x_obs.shape)} for {rows} rows")
    return rows


def outer_project(cfg: ProblemConfig, ws: Workspace, params: torch.Tensor,
                  b_eq_x: torch.Tensor, b_eq_y: torch.Tensor,
                  lamda_x: torch.Tensor, lamda_y: torch.Tensor, s_lane: torch.Tensor,
                  x_obs: Optional[torch.Tensor] = None, y_obs: Optional[torch.Tensor] = None,
                  arc_vec: Optional[torch.Tensor] = None,
                  kappa: Optional[torch.Tensor] = None, *, rows_per_cta: int = 0,
                  runtime_shape: bool = False, lib=None) -> OuterProjection:
    """The guess QP, the AM projection (``projection.maxiter`` rounds) and
    the controls of every row.

    params (rows, 8) the behavioural parameters; b_eq_x (rows, 3), b_eq_y
    (rows, 4) the boundary rows; lamda_x, lamda_y (rows, nvar) and s_lane
    (rows, 2 (num - 1)) the multipliers and the lane slack carried from the
    outer iteration before; x_obs, y_obs (N, num_obs, num) the obstacles
    of the N scenarios whose candidates the rows are, one scenario after
    another (read by the plain version: the scenario count of its products;
    by both versions with the obstacle terms), or None for one scenario
    without them; arc_vec and kappa
    (n_path,) the path of the Frenet solve, or None.  Returns
    :class:`OuterProjection`.

    CPU tensors take :func:`outer_project_plain`; CUDA tensors launch
    kernel (d) (float32, one device; the "prefactored" strategy, num <=
    128, nvar <= 16; with ``with_obstacle_terms`` its obstacle-active form,
    which reads x_obs, y_obs) or raise.  ``rows_per_cta`` (1
    or 2) and ``runtime_shape`` force the launch's choices
    (:func:`launch_choice`); ``lib``: another build of the kernels'
    library (``utils/kernel_ab.py``), else the package's.
    """
    rows = _check(cfg, ws, params, b_eq_x, b_eq_y, lamda_x, lamda_y, s_lane,
                  arc_vec, kappa, x_obs, y_obs)
    h = cfg.horizon
    per_cta, compiled = launch_choice(h.nvar, h.num, cfg.guess.num_segments, rows,
                                      rows_per_cta, runtime_shape)
    inputs = [params, b_eq_x, b_eq_y, lamda_x, lamda_y, s_lane]
    path = [] if arc_vec is None else [arc_vec, kappa]
    if all(t.device.type == "cpu" for t in inputs + path):
        return outer_project_plain(cfg, ws, params, b_eq_x, b_eq_y, lamda_x,
                                   lamda_y, s_lane, x_obs, y_obs, arc_vec, kappa)
    pj = cfg.projection
    if cfg.solve_strategy != "prefactored":
        raise ValueError("outer_project: the kernel takes the prefactored strategy "
                         "(outer_project_plain takes the exact one)")
    if not (h.num <= MAX_NUM and h.nvar <= MAX_NVAR
            and cfg.guess.num_segments <= MAX_SEGMENTS and pj.maxiter >= 1):
        raise ValueError(f"outer_project: the kernel takes num <= {MAX_NUM}, nvar <= "
                         f"{MAX_NVAR}, num_segments <= {MAX_SEGMENTS} and "
                         f"maxiter >= 1")
    inputs = [t.contiguous() for t in inputs]
    mats = [ws.G_vx, ws.G_py, ws.guess_kkt_x_inv, ws.guess_kkt_y_inv, ws.P, ws.Pdot,
            ws.Pddot, ws.A_lane, ws.proj_kkt_x_inv, ws.proj_kkt_y_inv]
    obs = []
    if pj.with_obstacle_terms:
        obs = [x_obs.contiguous(), y_obs.contiguous()]
    _build.require_cuda_f32("outer_project", *inputs, *mats, *path, *obs)
    dev, nvar, num = params.device, h.nvar, h.num
    out = OuterProjection(*(torch.empty(rows, n, dtype=torch.float32, device=dev)
                            for n in (nvar, nvar, num, num, num, num, num, num, 1,
                                      nvar, nvar, 2 * (num - 1), num, num, num, num)))
    out = out._replace(res_norm=out.res_norm.reshape(rows))
    lib = lib or _build.library()
    err = lib.mmd_outer_project(
        *(t.data_ptr() for t in inputs), *(m.data_ptr() for m in mats),
        *((t.data_ptr() for t in path) if path else (None, None)),
        *(t.data_ptr() for t in out),
        rows, nvar, num, cfg.guess.num_segments, pj.maxiter,
        arc_vec.shape[0] if path else 0, *constants(cfg), per_cta, int(compiled),
        *((t.data_ptr() for t in obs) if obs else (None, None)),
        obs[0].shape[-2] if obs else 0,
        rows // (1 if obs[0].dim() == 2 else obs[0].shape[0]) if obs else 0,
        *obstacle_constants(cfg), _build.stream())
    _build.check(err, "outer_project")
    outer_project.launches += 1
    return out


outer_project.launches = 0
