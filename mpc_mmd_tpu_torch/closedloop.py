"""Closed-loop receding-horizon MPC against a synthetic plant.

Counterpart of ``mpc_mmd_tpu/closedloop.py``.  Each step: the 300 m
waypoint window of the route, shifted to the ego, smoothed, and its path
parameters; the visible obstacles (front half-plane, nearest first, padded
to ``num_obs``) converted to Frenet and predicted at constant velocity; one
Frenet solve warm-started from the last step's mean; the mean of the first
``num_mean_update`` steps of (v, steer) applied with actuation noise; a
collision ends the episode.

The plant, the actuator, perception and the control noise (numpy, seeded
``3*seed + 5*i + 23`` per step) stay host numpy, exactly as in the JAX
package; the path, the conversions and the solve run on the solver's
device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .config import ProblemConfig
from .dynamics import constant_velocity_obstacles
from .frenet import (SmootherWorkspace, build_smoother, fit_path_spline,
                     global_to_frenet_obstacle, path_parameters, smooth_path,
                     waypoint_window)
from .solver_frenet import FrenetSolver


def make_route(kind: str = "curved", length: float = 1000.0,
               n_points: int = 25000):
    """A global route: straight, curved (gentle S-bends) or circuit."""
    s = np.linspace(0.0, length, n_points)
    if kind == "straight":
        x, y = s, np.zeros_like(s)
    elif kind == "curved":
        x = s
        y = 20.0 * np.sin(2 * np.pi * s / 400.0)
    elif kind == "circuit":
        r = length / (2 * np.pi)
        x = r * np.sin(s / r)
        y = r * (1.0 - np.cos(s / r))
    else:
        raise ValueError(kind)
    return x, y


@dataclass
class EpisodeResult:
    collided: bool
    steps: int
    distance: float
    min_obstacle_margin: float
    ego_trace: np.ndarray            # (steps, 5) [x, y, v, psi, steer]
    solve_times: List[float] = field(default_factory=list)
    # (steps, num_world_obs, 2) obstacle xy per step, for the animation
    obs_trace: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0, 2)))


class SyntheticPlant:
    """Bicycle-kinematics world with constant-velocity obstacle vehicles."""

    def __init__(self, cfg: ProblemConfig, route_xy, obstacles_s_l,
                 obstacle_speed: float = 0.0, v0: float = 5.0):
        self.cfg = cfg
        self.dt = cfg.horizon.dt
        self.L = cfg.vehicle.wheel_base
        self.spline = fit_path_spline(*route_xy)
        # obstacles at (arc, lateral) positions along the route
        obs = []
        for s_pos, l_pos in obstacles_s_l:
            xr = float(self.spline.cs_x(s_pos))
            yr = float(self.spline.cs_y(s_pos))
            phi = float(self.spline.cs_phi(s_pos))
            nx, ny = -np.sin(phi), np.cos(phi)
            tx, ty = np.cos(phi), np.sin(phi)
            obs.append((xr + l_pos * nx, yr + l_pos * ny,
                        obstacle_speed * tx, obstacle_speed * ty, phi))
        self.obstacles = np.asarray(obs) if obs else np.zeros((0, 5))
        phi0 = float(self.spline.cs_phi(0.0))
        self.state = np.array([float(self.spline.cs_x(0.0)),
                               float(self.spline.cs_y(0.0)),
                               v0, phi0, 0.0])  # x, y, v, psi, psidot
        self.vdot = 0.0

    def step(self, acc: float, steer: float):
        x, y, v, psi, _ = self.state
        v_next = max(v + acc * self.dt, 0.0)
        psidot = v_next * np.tan(steer) / self.L
        psi_next = psi + psidot * self.dt
        x_next = x + v_next * np.cos(psi_next) * self.dt
        y_next = y + v_next * np.sin(psi_next) * self.dt
        self.vdot = (v_next - v) / self.dt
        self.state = np.array([x_next, y_next, v_next, psi_next, psidot])
        if len(self.obstacles):
            self.obstacles[:, 0] += self.obstacles[:, 2] * self.dt
            self.obstacles[:, 1] += self.obstacles[:, 3] * self.dt

    def obstacle_margin(self) -> float:
        """Least ellipse margin over the obstacles (<= 0 is a collision)."""
        if not len(self.obstacles):
            return np.inf
        dx = self.state[0] - self.obstacles[:, 0]
        dy = self.state[1] - self.obstacles[:, 1]
        m = (dx ** 2 / self.cfg.obstacles.a_obs ** 2
             + dy ** 2 / self.cfg.obstacles.b_obs ** 2) - 1.0
        return float(np.min(m))


class PIDActuator:
    """Throttle/brake actuation: a PID on the smoothed measured acceleration
    drives a pedal integrator, the pedal maps to throttle or brake around the
    rolling and aerodynamic resistance (flat road), and ``step`` returns the
    acceleration the vehicle realises.  Reproduces the reference harness's
    actuation lag."""

    def __init__(self, dt: float, mass: float = 1845.0, kp: float = 0.05,
                 ki: float = 0.0, kd: float = 0.05):
        self.dt, self.mass = dt, mass
        self.kp, self.ki, self.kd = kp, ki, kd
        self.throttle1 = 0.0
        self.prev_vel = 0.0
        self.prev_acc = 0.0
        self._integral = 0.0
        self._last_input = 0.0

    def _pid(self, setpoint: float, inp: float) -> float:
        err = setpoint - inp
        self._integral += self.ki * err * self.dt
        # derivative on the measurement
        d_input = (inp - self._last_input) / self.dt
        self._last_input = inp
        return self.kp * err + self._integral - self.kd * d_input

    def step(self, target_acc: float, vel: float) -> float:
        lower = -(0.01 * 9.81 * self.mass
                  + 0.5 * 0.3 * 2.37 * 1.184 * vel ** 2) / self.mass
        upper = lower - 500.0 / self.mass

        acc = (vel - self.prev_vel) / self.dt
        if acc > 10.0:                       # spike guard
            control = self._pid(target_acc, 0.0)
        else:
            self.prev_acc = (self.prev_acc * 4.0 + acc) / 5.0
            control = self._pid(target_acc, self.prev_acc)
        self.throttle1 = float(np.clip(self.throttle1 + control, -4.0, 4.0))

        if self.throttle1 > lower:
            throttle = min((self.throttle1 - lower) / 4.0, 1.0)
            realized = lower + 4.0 * throttle
        elif self.throttle1 > upper:
            realized = lower                  # coasting: resistance only
        else:
            brake = min((upper - self.throttle1) / 4.0, 1.0)
            realized = upper - 4.0 * brake
        self.prev_vel = vel
        return realized


def perceive_obstacles(cfg: ProblemConfig, plant: SyntheticPlant,
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


def local_problem(cfg: ProblemConfig, plant: SyntheticPlant,
                  smoother: SmootherWorkspace, tot_time: torch.Tensor):
    """The solve's inputs at the plant's state, in the ego-shifted frame
    (ego at the origin, heading psi): the smoothed local path's
    :class:`FrenetFrame`, the visible obstacles' constant-velocity Frenet
    trajectories x_obs, y_obs (num_obs, num), and the global state
    [0, 0, v, vdot, psi, psidot], on ``tot_time``'s device."""
    dev = tot_time.device
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    x_e, y_e, v_e, psi_e, psidot_e = plant.state
    x_wp, y_wp, _ = waypoint_window(plant.spline, x_e, y_e,
                                    cfg.frenet.lookahead, cfg.frenet.num_path)
    x_sm, y_sm = smooth_path(smoother, f32(x_wp - x_e), f32(y_wp - y_e),
                             cfg.frenet.smooth_threshold)
    frame = path_parameters(x_sm, y_sm)

    obs_shift = perceive_obstacles(cfg, plant, (x_e, y_e), psi_e).copy()
    obs_shift[:, 0] -= x_e
    obs_shift[:, 1] -= y_e
    s_o, l_o, vs_o, vl_o, psi_o = global_to_frenet_obstacle(
        frame, *f32(obs_shift[:, :5]).unbind(1))
    x_obs, y_obs, _ = constant_velocity_obstacles(s_o, l_o, vs_o, vl_o, psi_o,
                                                  tot_time)
    init_global = f32([0.0, 0.0, v_e, plant.vdot, psi_e, psidot_e])
    return frame, x_obs, y_obs, init_global


def run_episode(cfg: ProblemConfig, route_kind: str = "curved",
                obstacles_s_l=((60.0, 0.0), (140.0, 1.5)),
                v_des: float = 15.0, max_steps: int = 400,
                goal_arc: float = 300.0, seed: int = 0,
                noise_on_control: bool = True,
                solver: Optional[FrenetSolver] = None,
                actuation: str = "direct", device="cuda") -> EpisodeResult:
    """Run one closed-loop episode; returns collision and progress metrics.

    actuation: "direct" feeds the MPC acceleration straight to the plant;
    "pid" routes it through :class:`PIDActuator`.  The solve runs on
    ``solver``'s device, or on ``device`` (the card by default; raises
    without one, ``device="cpu"`` for the CPU) with a new
    :class:`FrenetSolver`.  A solve's time ends at ``torch.cuda.synchronize``
    on the card.
    """
    if actuation not in ("direct", "pid"):
        raise ValueError(f"actuation must be 'direct' or 'pid', got "
                         f"{actuation!r}")
    solver = solver or FrenetSolver(cfg, device=device)
    dev = solver.device
    plant = SyntheticPlant(cfg, make_route(route_kind), obstacles_s_l)
    smoother = build_smoother(cfg.frenet.num_path, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    mean = f32([v_des] * 4 + [0.0] * 4)
    cov = f32(np.diag([20.0] * 4 + [100.0] * 4))
    tot_time = f32(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num))
    nmu = cfg.frenet.num_mean_update
    # max(nmu-1, 1): num_mean_update == 1 would otherwise make the
    # velocity->acceleration conversion below divide by zero
    t_target = max(nmu - 1, 1) * cfg.horizon.dt
    actuator = PIDActuator(cfg.horizon.dt) if actuation == "pid" else None
    if actuator is not None:
        actuator.prev_vel = float(plant.state[2])

    trace, obs_trace, times = [], [], []
    collided = False
    min_margin = np.inf
    goal_xy = np.array([float(plant.spline.cs_x(goal_arc)),
                        float(plant.spline.cs_y(goal_arc))])

    i = 0
    for i in range(max_steps):
        v_e = plant.state[2]
        if np.linalg.norm(plant.state[:2] - goal_xy) < 7.0:
            break
        frame, x_obs, y_obs, init_global = local_problem(cfg, plant, smoother,
                                                         tot_time)
        t0 = time.perf_counter()
        r = solver.solve(i, init_global, mean, cov, x_obs, y_obs, v_des, frame)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        mean = r.mean_param  # receding-horizon warm start

        # the control, with actuation noise
        v_ctrl = float(torch.mean(r.v_best[:nmu]))
        steer_ctrl = float(np.clip(float(torch.mean(r.steering_best[:nmu])),
                                   -cfg.vehicle.steer_max,
                                   cfg.vehicle.steer_max))
        a_ctrl = (v_ctrl - v_e) / t_target

        if noise_on_control:
            np.random.seed(3 * seed + 5 * i + 23)
            if cfg.noise.kind == "gaussian":
                eps = float(np.random.normal(0, 1))
                a_ctrl = a_ctrl + cfg.noise.level * abs(a_ctrl) * eps
                steer_ctrl = steer_ctrl + cfg.noise.level * abs(steer_ctrl) * eps
            else:
                b1 = float(np.random.beta(cfg.noise.beta_a * abs(a_ctrl) + 1e-6,
                                          cfg.noise.beta_b * abs(a_ctrl) + 1e-6))
                a_ctrl = a_ctrl + cfg.noise.level * (2 * b1 - 1)
                b2 = float(np.random.beta(
                    cfg.noise.beta_a * abs(steer_ctrl) + 1e-6,
                    cfg.noise.beta_b * abs(steer_ctrl) + 1e-6))
                steer_ctrl = steer_ctrl + cfg.noise.level * (2 * b2 - 1)
            a_ctrl = a_ctrl + cfg.noise.acc_const * float(np.random.normal(0, 1))
            steer_ctrl = steer_ctrl + cfg.noise.steer_const * float(
                np.random.normal(0, 1))

        if actuator is not None:
            a_ctrl = actuator.step(a_ctrl, v_e)
        plant.step(a_ctrl, steer_ctrl)
        trace.append([*plant.state[:4], steer_ctrl])
        obs_trace.append(plant.obstacles[:, :2].copy()
                         if len(plant.obstacles) else np.zeros((0, 2)))

        margin = plant.obstacle_margin()
        min_margin = min(min_margin, margin)
        if margin <= 0.0:
            collided = True
            break

    distance = float(np.linalg.norm(plant.state[:2]
                                    - np.array(make_route(route_kind))[:, 0]))
    return EpisodeResult(collided=collided, steps=i + 1, distance=distance,
                         min_obstacle_margin=float(min_margin),
                         ego_trace=np.asarray(trace), solve_times=times,
                         obs_trace=(np.stack(obs_trace) if obs_trace
                                    else np.zeros((0, 0, 2))))
