# Frozen copy of mpc_mmd_tpu_torch/frenet.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""Frenet-frame toolkit: path splines, smoothing, global <-> Frenet transforms.

Counterpart of ``mpc_mmd_tpu/frenet.py``.  The route's arc-length spline
and the waypoint window stay host numpy and scipy, as in the JAX package:
they run once per episode and once per MPC step.  Everything per MPC step
after them is torch on the solver's device with static shapes: the
jerk-penalised path smoothing (its KKT inverse built once on the host in
float64), the path parameters, and the conversions.

The nearest-point search of the conversions is one batched distance
matrix and one ``argmin`` over all points, as in the JAX package (which
replaces the reference's per-point scan with it).  ``torch.argmin`` returns
the first minimum, as ``jnp.argmin`` does.  These chains are the plain
versions of kernel (g)'s forms (``ops/frenet_points.py``), which the
on-road solve and the closed loop run on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .device import resolve_device


class PathSpline(NamedTuple):
    """Host-side arc-length cubic spline of a global route."""

    arc_vec: np.ndarray
    arc_length: float
    cs_x: object
    cs_y: object
    cs_phi: object
    x_data: np.ndarray
    y_data: np.ndarray


class FrenetFrame(NamedTuple):
    """One MPC step's local path, float32 tensors on the solver's device."""

    x_path: torch.Tensor     # (num_path,) smoothed local path
    y_path: torch.Tensor
    Fx_dot: torch.Tensor     # path tangents (finite difference)
    Fy_dot: torch.Tensor
    arc_vec: torch.Tensor    # cumulative arc length
    kappa: torch.Tensor      # signed curvature
    arc_length: torch.Tensor  # ()


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for increasing 1-d ``xp``, in its arithmetic.

    Values clamp to ``fp[0]`` and ``fp[-1]`` outside ``[xp[0], xp[-1]]``;
    inside, ``fp[i-1] + (x - xp[i-1]) / dx * df`` with ``i`` the right-side
    insertion point clipped to ``[1, len - 1]``, so a point on a knot takes
    that knot's value.  An interval no wider than ``spacing(eps)`` takes its
    left value.
    """
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def fit_path_spline(x_path: np.ndarray, y_path: np.ndarray) -> PathSpline:
    """Arc-length cubic-spline fit of a route (host, scipy)."""
    from scipy.interpolate import CubicSpline

    x_diff = np.diff(x_path)
    y_diff = np.diff(y_path)
    phi = np.unwrap(np.arctan2(y_diff, x_diff))
    phi = np.hstack((phi[0], phi))
    arc = np.cumsum(np.sqrt(x_diff ** 2 + y_diff ** 2))
    arc_length = float(arc[-1])
    arc_vec = np.linspace(0, arc_length, x_path.shape[0])
    return PathSpline(arc_vec=arc_vec, arc_length=arc_length,
                      cs_x=CubicSpline(arc_vec, x_path),
                      cs_y=CubicSpline(arc_vec, y_path),
                      cs_phi=CubicSpline(arc_vec, phi),
                      x_data=np.asarray(x_path), y_data=np.asarray(y_path))


def waypoint_window(spline: PathSpline, x_ego: float, y_ego: float,
                    lookahead: float = 300.0, num_path: int = 600
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``num_path`` waypoints over ``lookahead`` metres of arc from the
    route point nearest the ego (host): x, y, heading."""
    idx = int(np.argmin(np.sqrt((x_ego - spline.x_data) ** 2
                                + (y_ego - spline.y_data) ** 2)))
    arc_curr = spline.arc_vec[idx]
    arc_look = np.linspace(arc_curr, arc_curr + lookahead, num_path)
    return (np.asarray(spline.cs_x(arc_look)),
            np.asarray(spline.cs_y(arc_look)),
            np.asarray(spline.cs_phi(arc_look)))


class SmootherWorkspace(NamedTuple):
    kkt_inv: torch.Tensor    # (num_path + 1, num_path + 1) float32
    num_path: int
    maxiter: int


def build_smoother(num_path: int = 600, rho: float = 1.0,
                   jerk_weight: float = 20.0, maxiter: int = 10,
                   device="cuda") -> SmootherWorkspace:
    """Jerk-penalised proximal smoothing QP: its KKT inverse, built on the
    host in float64 and moved to ``device`` (the card by default;
    ``device="cpu"`` for the CPU) in float32."""
    dev = resolve_device(device)
    I = np.eye(num_path)
    A_jerk = np.diff(np.diff(np.diff(I, axis=0), axis=0), axis=0)
    cost = jerk_weight * (A_jerk.T @ A_jerk) + rho * I
    A_eq = I[0:1]
    kkt = np.block([[cost, A_eq.T], [A_eq, np.zeros((1, 1))]])
    kkt_inv = np.linalg.inv(kkt).astype(np.float32)
    return SmootherWorkspace(kkt_inv=torch.from_numpy(kkt_inv).to(dev),
                             num_path=num_path, maxiter=maxiter)


def smooth_path(sw: SmootherWorkspace, x_wp: torch.Tensor, y_wp: torch.Tensor,
                threshold: float = 0.1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternating proximal smoothing within ``threshold`` of the waypoints
    (``maxiter`` rounds, each two (n+1)-square matrix-vector products)."""
    n = sw.num_path
    rho = 1.0
    alpha = torch.zeros_like(x_wp)
    d = torch.full_like(x_wp, threshold)
    lam_x = torch.zeros_like(x_wp)
    lam_y = torch.zeros_like(x_wp)
    for _ in range(sw.maxiter):
        b_x = x_wp + d * torch.cos(alpha)
        b_y = y_wp + d * torch.sin(alpha)
        rhs_x = torch.cat((lam_x + rho * b_x, x_wp[0:1]))
        rhs_y = torch.cat((lam_y + rho * b_y, y_wp[0:1]))
        x_s = (sw.kkt_inv @ rhs_x)[:n]
        y_s = (sw.kkt_inv @ rhs_y)[:n]

        wc = x_s - x_wp
        wsn = y_s - y_wp
        alpha = torch.atan2(wsn, wc)
        d = torch.clamp(wc * torch.cos(alpha) + wsn * torch.sin(alpha),
                        max=threshold)
        res_x = wc - d * torch.cos(alpha)
        res_y = wsn - d * torch.sin(alpha)
        lam_x = lam_x - rho * res_x
        lam_y = lam_y - rho * res_y
    return x_s, y_s


def path_parameters(x_path: torch.Tensor, y_path: torch.Tensor) -> FrenetFrame:
    """Finite-difference tangents, arc length and curvature of a path."""
    Fx_dot = torch.diff(x_path)
    Fy_dot = torch.diff(y_path)
    Fx_dot = torch.cat((Fx_dot[:1], Fx_dot))
    Fy_dot = torch.cat((Fy_dot[:1], Fy_dot))
    Fx_ddot = torch.diff(Fx_dot)
    Fy_ddot = torch.diff(Fy_dot)
    Fx_ddot = torch.cat((Fx_ddot[:1], Fx_ddot))
    Fy_ddot = torch.cat((Fy_ddot[:1], Fy_ddot))
    arc = torch.cumsum(torch.sqrt(Fx_dot ** 2 + Fy_dot ** 2), dim=0)
    arc_vec = torch.cat((torch.zeros_like(arc[:1]), arc[:-1]))
    kappa = (Fy_ddot * Fx_dot - Fx_ddot * Fy_dot) / (
        (Fx_dot ** 2 + Fy_dot ** 2) ** 1.5)
    return FrenetFrame(x_path=x_path, y_path=y_path, Fx_dot=Fx_dot,
                       Fy_dot=Fy_dot, arc_vec=arc_vec, kappa=kappa,
                       arc_length=arc_vec[-1])


def _nearest(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Index of the path point nearest each point of the 1-d x, y: the
    argmin of dx^2 + dy^2, squared and summed in place (two (points, path)
    buffers, not five)."""
    dx = x[:, None] - frame.x_path[None, :]
    dy = y[:, None] - frame.y_path[None, :]
    return torch.argmin(dx.mul_(dx).add_(dy.mul_(dy)), dim=1)


def _frame_at(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor):
    """For each point of the 1-d x, y: its arc length s (that of the
    nearest path point), the tangent (tx, ty) there, and its signed lateral
    offset l along the unit normal (-ty, tx)."""
    idx = _nearest(frame, x, y)
    cx, cy = frame.x_path[idx], frame.y_path[idx]
    s = frame.arc_vec[idx]
    tx = interp(s, frame.arc_vec, frame.Fx_dot)
    ty = interp(s, frame.arc_vec, frame.Fy_dot)
    l = (-ty * (x - cx) + tx * (y - cy)) / torch.sqrt(ty * ty + tx * tx)
    return s, tx, ty, l


def _relative_heading(psi: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    psi_rel = psi - torch.atan2(ty, tx)
    return torch.atan2(torch.sin(psi_rel), torch.cos(psi_rel))


def global_to_frenet_state(frame: FrenetFrame, state: torch.Tensor) -> Tuple:
    """Global states (n, 6) rows [x, y, v, vdot, psi, psidot] to Frenet, with
    the velocity and acceleration chain rule through kappa and kappa'.

    Returns (s, l, vs, vl, as_, al, psi_rel, psi_fin, psidot_rel), each
    (n,); ``psi_fin`` is 0, as in the JAX package.
    """
    x_g, y_g, v_g, vdot_g, psi_g, psidot_g = state.unbind(1)
    s, tx, ty, l = _frame_at(frame, x_g, y_g)
    kappa_i = interp(s, frame.arc_vec, frame.kappa)
    kappa_p = interp(s + 0.001, frame.arc_vec, frame.kappa)
    kappa_prime = (kappa_p - kappa_i) / 0.001
    psi_rel = _relative_heading(psi_g, tx, ty)

    vs = v_g * torch.cos(psi_rel) / (1.0 - l * kappa_i)
    vl = v_g * torch.sin(psi_rel)
    psidot_rel = psidot_g - kappa_i * vs

    al = vdot_g * torch.sin(psi_rel) + v_g * torch.cos(psi_rel) * psidot_rel
    as_p1 = vdot_g * torch.cos(psi_rel) - v_g * torch.sin(psi_rel) * psidot_rel
    as_p2 = -vl * kappa_i - l * kappa_prime * vs
    as_ = (as_p1 * (1.0 - l * kappa_i)
           - (v_g * torch.cos(psi_rel)) * as_p2) / ((1.0 - l * kappa_i) ** 2)
    return s, l, vs, vl, as_, al, psi_rel, torch.zeros_like(s), psidot_rel


def global_to_frenet_obstacle(frame: FrenetFrame, x_o, y_o, vx_o, vy_o, psi_o):
    """Obstacles (each argument (num_obs,)) to Frenet: (s, l, vs, vl,
    psi_rel), each (num_obs,); every row as the JAX package converts one
    obstacle."""
    v_o = torch.sqrt(vx_o ** 2 + vy_o ** 2)
    s, tx, ty, l = _frame_at(frame, x_o, y_o)
    kappa_i = interp(s, frame.arc_vec, frame.kappa)
    psi_rel = _relative_heading(psi_o, tx, ty)
    vs = v_o * torch.cos(psi_rel) / (1.0 - l * kappa_i)
    vl = v_o * torch.sin(psi_rel)
    return s, l, vs, vl, psi_rel


def initial_states(frame: FrenetFrame, z: torch.Tensor, init_state: torch.Tensor,
                   mu, sig, nb: int):
    """The on-road solve's n noisy initial states and its boundary rows,
    from the standard normals ``z`` (n, 4) and the global state
    ``init_state`` (6,) [x, y, v, vdot, psi, psidot]: (x, y) perturbed by
    ``z``'s first two columns times ``sig`` plus ``mu``, the velocity and
    heading shared; their Frenet states (:func:`global_to_frenet_state`)
    and the means of s, l, vs, vl, as, al.  Returns the states (n, 5) [x,
    y, vx, vy, psi], b_eq_x (nb, 3) [s, vs, as] and b_eq_y (nb, 4) [l, vl,
    al, 0], every row the means."""
    n, dev = z.shape[0], z.device
    x_g, y_g, v_g, vdot_g, psi_g, psidot_g = init_state.unbind(0)
    vx_g = v_g * torch.cos(psi_g)
    vy_g = v_g * torch.sin(psi_g)
    xs = x_g + z[:, 0] * sig[0] + mu[0]
    ys = y_g + z[:, 1] * sig[1] + mu[1]
    ones = torch.ones(n, device=dev)
    vxs, vys = vx_g * ones, vy_g * ones
    psis = torch.atan2(vy_g, vx_g) * ones
    temps = torch.stack((xs, ys, torch.sqrt(vxs ** 2 + vys ** 2),
                         vdot_g * ones, psis, psidot_g * ones), dim=1)
    conv = global_to_frenet_state(frame, temps)
    s_m, l_m, vs_m, vl_m, as_m, al_m = (c.sum() * (1.0 / n) for c in conv[:6])
    nb1 = torch.ones((nb, 1), device=dev)
    b_eq_x = torch.cat((s_m * nb1, vs_m * nb1, as_m * nb1), dim=1)
    b_eq_y = torch.cat((l_m * nb1, vl_m * nb1, al_m * nb1, torch.zeros_like(nb1)), dim=1)
    return torch.stack((xs, ys, vxs, vys, psis), dim=1), b_eq_x, b_eq_y


def global_to_frenet_points(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pointwise (s, l) of trajectory batches (..., T), one batched
    nearest-point reduction over all points."""
    s, _, _, l = _frame_at(frame, x.reshape(-1), y.reshape(-1))
    return s.reshape(x.shape), l.reshape(x.shape)


