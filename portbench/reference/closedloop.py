# Frozen copy of mpc_mmd_tpu_torch/closedloop.py's perception and local
# problem (commit eb91b04), on the plain versions of kernels (g) and (h).
# The benchmark's yardstick: do not edit it to follow the port.
"""A closed-loop step's local problem, as the program builds it: the
waypoint window, perception, the smoothed local path and its parameters,
and the obstacles' Frenet trajectories."""

from __future__ import annotations

import numpy as np
import torch

from .config import ProblemConfig
from .dynamics import constant_velocity_obstacles
from .frenet import (SmootherWorkspace, global_to_frenet_obstacle, path_parameters,
                     smooth_path, waypoint_window)


def perceive_obstacles(cfg: ProblemConfig, plant,
                       ego_xy, ego_psi) -> np.ndarray:
    """Front-half-plane filter, nearest first, padded to exactly
    ``num_obs`` rows with a far-away dummy obstacle."""
    n = cfg.obstacles.num_obs
    dummy = np.array([ego_xy[0] + 500.0, ego_xy[1] + 500.0, 0.0, 0.0, 0.0])
    if not len(plant.obstacles):
        return np.tile(dummy, (n, 1))
    rel = plant.obstacles[:, :2] - np.asarray(ego_xy)[None, :]
    heading = np.array([np.cos(ego_psi), np.sin(ego_psi)])
    ahead = rel @ heading > -5.0
    vis = plant.obstacles[ahead]
    if not len(vis):
        return np.tile(dummy, (n, 1))
    d = np.linalg.norm(vis[:, :2] - np.asarray(ego_xy)[None, :], axis=1)
    vis = vis[np.argsort(d)][:n]
    if len(vis) < n:
        vis = np.vstack([vis] + [dummy[None, :]] * (n - len(vis)))
    return vis


def local_problem(cfg: ProblemConfig, plant,
                  smoother: SmootherWorkspace, tot_time: torch.Tensor):
    """The solve's inputs at the plant's state, in the ego-shifted frame
    (ego at the origin, heading psi): the smoothed local path's
    :class:`FrenetFrame`, the visible obstacles' constant-velocity Frenet
    trajectories x_obs, y_obs (num_obs, num), and the global state
    [0, 0, v, vdot, psi, psidot], on ``tot_time``'s device.  The host's
    waypoints, obstacle rows and state go over in one copy (from pinned
    memory on the card); the frame is the smoother's rounds and the path
    parameters (kernel (h)'s stage), the obstacles' Frenet states and
    constant-velocity trajectories kernel (g)'s obstacle form's."""
    dev = tot_time.device
    x_e, y_e, v_e, psi_e, psidot_e = plant.state
    n, m = cfg.frenet.num_path, cfg.obstacles.num_obs
    x_wp, y_wp, _ = waypoint_window(plant.spline, x_e, y_e, cfg.frenet.lookahead, n)
    obs = perceive_obstacles(cfg, plant, (x_e, y_e), psi_e)[:, :5].copy()
    obs[:, 0] -= x_e
    obs[:, 1] -= y_e
    host = torch.empty(2 * n + 5 * m + 6, dtype=torch.float32,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()
    h[:n] = x_wp - x_e
    h[n:2 * n] = y_wp - y_e
    h[2 * n:2 * n + 5 * m] = obs.reshape(-1)
    h[2 * n + 5 * m:] = (0.0, 0.0, v_e, plant.vdot, psi_e, psidot_e)
    buf = host.to(dev, non_blocking=True)
    frame = path_parameters(*smooth_path(smoother, buf[:n], buf[n:2 * n],
                                         cfg.frenet.smooth_threshold))
    frenet_obs = global_to_frenet_obstacle(frame, *buf[2 * n:2 * n + 5 * m].view(m, 5).unbind(1))
    x_obs, y_obs = constant_velocity_obstacles(*frenet_obs, tot_time)[:2]
    return frame, x_obs, y_obs, buf[2 * n + 5 * m:]
