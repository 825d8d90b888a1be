"""The benchmark's frozen world: what it feeds the program, made from the
seed, kept here so that a change to the program cannot change the
yardstick.

* :func:`static_grid`, :func:`ego_initial_state`: static obstacles on the
  2-lane grid and the ego's start (copies of ``mpc_mmd_tpu_torch.scenarios``
  at commit eb91b04, host numpy);
* :func:`make_route`, :class:`SyntheticPlant`, :func:`actuation`: the
  closed loop's route, kinematic plant with constant-velocity obstacles,
  and the control applied to it with its Gaussian actuation noise (copies
  of ``mpc_mmd_tpu_torch.closedloop``'s, "direct" actuation).

Perception and the waypoint window are not here: they belong to the
program's ``local_problem``, which the closed loop times.
"""

from __future__ import annotations

import numpy as np

from ..reference.frenet import fit_path_spline

STATIC_X_GRID = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], dtype=np.float64)
LANE_YS = np.array([-1.75, 1.75])


def static_grid(num_obs: int, num: int, seeds):
    """Obstacle trajectories x, y (len(seeds), num_obs, num), float32: scenario
    k's obstacles drawn with numpy's ``RandomState(seeds[k])`` on the grid,
    standing still (the reference's compute_obs_data)."""
    xs = np.zeros((len(seeds), num_obs))
    ys = np.zeros((len(seeds), num_obs))
    for k, s in enumerate(seeds):
        rng = np.random.RandomState(int(s))
        xs[k] = rng.choice(STATIC_X_GRID, (num_obs,), replace=False)
        ys[k] = rng.choice(LANE_YS, (num_obs,))
    rep = lambda a: np.repeat(a[:, :, None], num, axis=2).astype(np.float32)
    return rep(xs), rep(ys)


def static_pool(rng: np.random.Generator, num_obs: int, num: int, size: int):
    """:func:`static_grid` of ``size`` scenarios whose numpy seeds ``rng``
    draws."""
    return static_grid(num_obs, num, rng.integers(0, 2 ** 31 - 1, size=size))


def ego_initial_state():
    """(init_state (6,), CEM mean (8,), CEM cov (8, 8), v_des): the ego at
    y = +1.75 at 5 m/s, desired speed 15 m/s."""
    v_des = 15.0
    init_state = np.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], np.float32)
    mean = np.asarray([v_des] * 4 + [0.0] * 4, np.float32)
    cov = np.diag([20.0] * 4 + [100.0] * 4).astype(np.float32)
    return init_state, mean, cov, v_des


def make_route(kind: str = "curved", length: float = 1000.0, n_points: int = 25000):
    """A global route: straight, curved (gentle S-bends) or circuit."""
    s = np.linspace(0.0, length, n_points)
    if kind == "straight":
        return s, np.zeros_like(s)
    if kind == "curved":
        return s, 20.0 * np.sin(2 * np.pi * s / 400.0)
    if kind == "circuit":
        r = length / (2 * np.pi)
        return r * np.sin(s / r), r * (1.0 - np.cos(s / r))
    raise ValueError(kind)


def route_spline(kind: str = "curved"):
    """The route's arc-length spline (host scipy), fitted once a run."""
    return fit_path_spline(*make_route(kind))


class SyntheticPlant:
    """Bicycle kinematics of wheel base ``wheel_base`` stepped every ``dt``
    seconds, with constant-velocity obstacles at (arc, lateral) positions
    along the route; ``a_obs``, ``b_obs`` the obstacles' safety ellipse.
    ``spline``, ``state`` [x, y, v, psi, psidot], ``vdot`` and
    ``obstacles`` (n, 5) [x, y, vx, vy, psi] are what the program's
    ``local_problem`` reads; ``spline`` is :func:`route_spline`'s."""

    def __init__(self, spline, obstacles_s_l, dt: float, wheel_base: float,
                 a_obs: float, b_obs: float, obstacle_speed: float = 0.0,
                 v0: float = 5.0):
        self.dt, self.L, self.a_obs, self.b_obs = dt, wheel_base, a_obs, b_obs
        self.spline = spline
        obs = []
        for s_pos, l_pos in obstacles_s_l:
            xr, yr = float(self.spline.cs_x(s_pos)), float(self.spline.cs_y(s_pos))
            phi = float(self.spline.cs_phi(s_pos))
            nx, ny = -np.sin(phi), np.cos(phi)
            tx, ty = np.cos(phi), np.sin(phi)
            obs.append((xr + l_pos * nx, yr + l_pos * ny,
                        obstacle_speed * tx, obstacle_speed * ty, phi))
        self.obstacles = np.asarray(obs) if obs else np.zeros((0, 5))
        phi0 = float(self.spline.cs_phi(0.0))
        self.state = np.array([float(self.spline.cs_x(0.0)), float(self.spline.cs_y(0.0)),
                               v0, phi0, 0.0])
        self.vdot = 0.0

    def step(self, acc: float, steer: float):
        x, y, v, psi, _ = self.state
        v_next = max(v + acc * self.dt, 0.0)
        psidot = v_next * np.tan(steer) / self.L
        psi_next = psi + psidot * self.dt
        self.vdot = (v_next - v) / self.dt
        self.state = np.array([x + v_next * np.cos(psi_next) * self.dt,
                               y + v_next * np.sin(psi_next) * self.dt,
                               v_next, psi_next, psidot])
        if len(self.obstacles):
            self.obstacles[:, 0] += self.obstacles[:, 2] * self.dt
            self.obstacles[:, 1] += self.obstacles[:, 3] * self.dt

    def obstacle_margin(self) -> float:
        """Least ellipse margin over the obstacles (<= 0 is a collision)."""
        if not len(self.obstacles):
            return np.inf
        dx = self.state[0] - self.obstacles[:, 0]
        dy = self.state[1] - self.obstacles[:, 1]
        return float(np.min(dx ** 2 / self.a_obs ** 2 + dy ** 2 / self.b_obs ** 2 - 1.0))

    def snapshot(self):
        """What a step's inputs are made of: (state, vdot, obstacles), copies."""
        return self.state.copy(), float(self.vdot), self.obstacles.copy()


def actuation(v_ctrl: float, steer_ctrl: float, v_e: float, t_target: float,
              steer_max: float, level: float, acc_const: float, steer_const: float,
              rng: np.random.RandomState):
    """The (acceleration, steering) applied to the plant: the solve's mean
    speed reached over ``t_target`` seconds and its mean steering clipped,
    each with Gaussian actuation noise of relative level ``level`` (one
    normal for both) and the constant noises."""
    steer_ctrl = float(np.clip(steer_ctrl, -steer_max, steer_max))
    a_ctrl = (v_ctrl - v_e) / t_target
    eps = float(rng.normal(0, 1))
    a_ctrl += level * abs(a_ctrl) * eps
    steer_ctrl += level * abs(steer_ctrl) * eps
    a_ctrl += acc_const * float(rng.normal(0, 1))
    steer_ctrl += steer_const * float(rng.normal(0, 1))
    return a_ctrl, steer_ctrl
