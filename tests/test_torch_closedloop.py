"""The port's closed loop against the JAX package's: plant, actuator,
perception, whole episodes, and the closed-loop CLI.

The plant, the PID actuator and perception are host numpy in both packages
and must be equal exactly.  Episodes run both packages' ``run_episode`` at
the small size of tests/test_closedloop.py, the port's on the CPU with the
JAX package's draws at every MPC step (:class:`JaxKeyedNoise`: the keys
depend on the step index); the ego trace (x, y, v, psi, steer after each
step) must agree within 1e-3 after 3 steps, the JAX package's parity bar.
The two obstacles block both lanes 12-18 m ahead, so every candidate's
risk (and in ``det`` its obstacle residual) is distinct: where candidates
tie at zero, the one returned has the least projection residual, which is
float32 round-off (~1e-6) and orders differently in the two packages (see
tests/test_torch_modes.py).  The behavioural checks of tests/test_closedloop.py (progress without a
collision, the det baseline, the PID lag) run on the port alone.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import mpc_mmd_tpu.closedloop as jcl
from mpc_mmd_tpu.config import onroad_workload as j_onroad
from mpc_mmd_tpu_torch import closedloop as tcl
from mpc_mmd_tpu_torch.cli import closedloop as tcli
from mpc_mmd_tpu_torch.noise import InnerDraws, init_state_count
from mpc_mmd_tpu_torch.solver_frenet import FrenetSolver
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)


def tiny(mode, **kw):
    cfg = j_onroad(num_reduced=3, num_obs=2, num_prime=20, mode=mode, **kw)
    return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=3),
                       beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=3))


class JaxKeyedNoise:
    """The JAX package's draws of each MPC step, computed when the solve
    asks for them (``jax_draws`` of the step plus the noisy initial states'
    ``split(PRNGKey(idx_mpc))[0]``), by a key table of (idx_mpc, it)."""

    capturable = False

    def __init__(self, cfg):
        self.cfg, self._steps = cfg, {}

    def _draws(self, idx_mpc):
        if idx_mpc not in self._steps:
            d = jax_draws(self.cfg, idx_mpc)
            key = jax.random.split(jax.random.PRNGKey(idx_mpc))[0]
            d["init_state_z"] = np.asarray(jax.random.normal(
                key, (init_state_count(self.cfg), 4)))
            self._steps[idx_mpc] = {k: torch.tensor(v) for k, v in d.items()}
        return self._steps[idx_mpc]

    def initial_z(self, nb, n_params):
        return self._draws(0)["initial_z"]

    def inner_cem(self, S, M, n_el, maxiter):
        d = self._draws(0)
        return InnerDraws(d["samples0"], d["u"], d["z"])

    def keys(self, seeds, iterations):
        """(1, iterations, 2): the step's (idx_mpc, it) pairs."""
        (s,) = seeds
        return torch.tensor([[[s, it] for it in range(iterations)]])

    def init_key(self, idx_mpc):
        return torch.tensor([idx_mpc])

    def init_state_z(self, key, n):
        return self._draws(int(key[0]))["init_state_z"]

    def rollout_eps(self, keys, R, T):
        (s, it), = keys.tolist()
        d = self._draws(s)
        return d["eps_acc"][it][None], d["eps_steer"][it][None], d["eps_const"][it][None]

    def cem_z(self, keys, n, n_params):
        (s, it), = keys.tolist()
        return self._draws(s)["cem_z"][it][None]


def test_plant_actuator_and_perception_equal_jax():
    cfg = tiny("cvar")
    route = jcl.make_route("curved")
    np.testing.assert_array_equal(tcl.make_route("curved"), route)
    obstacles = [(30.0, 0.0), (-20.0, 0.0), (45.0, 1.5)]
    jp = jcl.SyntheticPlant(cfg, route, obstacles, obstacle_speed=1.0)
    tp = tcl.SyntheticPlant(to_torch_cfg(cfg), route, obstacles, obstacle_speed=1.0)
    ja, ta = jcl.PIDActuator(0.15), tcl.PIDActuator(0.15)
    ja.prev_vel = ta.prev_vel = 5.0
    for k in range(12):
        acc_j = ja.step(3.0 - 0.5 * k, float(jp.state[2]))
        acc_t = ta.step(3.0 - 0.5 * k, float(tp.state[2]))
        assert acc_j == acc_t
        jp.step(acc_j, 0.05 * np.sin(k))
        tp.step(acc_t, 0.05 * np.sin(k))
        np.testing.assert_array_equal(tp.state, jp.state)
        np.testing.assert_array_equal(tp.obstacles, jp.obstacles)
        assert tp.obstacle_margin() == jp.obstacle_margin()
        for ego in ((jp.state[0], jp.state[1]), (0.0, 0.0), (60.0, 5.0)):
            np.testing.assert_array_equal(
                tcl.perceive_obstacles(to_torch_cfg(cfg), tp, ego, jp.state[3]),
                jcl.perceive_obstacles(cfg, jp, ego, jp.state[3]))
    assert ta.throttle1 == ja.throttle1


@pytest.mark.parametrize("mode", ["det", "cvar"])
def test_three_step_episode_matches_jax(mode):
    cfg = tiny(mode)
    kw = dict(route_kind="curved", obstacles_s_l=((12.0, 0.5), (18.0, 3.0)),
              v_des=10.0, max_steps=3, goal_arc=150.0, seed=1)
    ref = jcl.run_episode(cfg, **kw)
    solver = FrenetSolver(to_torch_cfg(cfg), device="cpu", noise=JaxKeyedNoise(cfg))
    got = tcl.run_episode(to_torch_cfg(cfg), solver=solver, **kw)
    assert got.steps == ref.steps == 3 and got.collided == ref.collided
    np.testing.assert_allclose(got.ego_trace, ref.ego_trace, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.obs_trace, ref.obs_trace, rtol=0, atol=1e-3)
    assert got.min_obstacle_margin == pytest.approx(ref.min_obstacle_margin,
                                                    abs=1e-3)


def test_cvar_episode_progresses_without_collision():
    r = tcl.run_episode(to_torch_cfg(tiny("cvar")), route_kind="curved",
                        obstacles_s_l=((70.0, 0.0),), v_des=10.0, max_steps=40,
                        goal_arc=150.0, seed=1, device="cpu")
    assert not r.collided
    assert len(r.ego_trace) == r.steps == len(r.solve_times)
    assert r.ego_trace[-1][0] > 20.0        # forward progress along the route
    assert r.ego_trace[-1][2] > 5.2         # accelerates from 5 toward v_des


def test_det_baseline_runs():
    r = tcl.run_episode(to_torch_cfg(tiny("det")), route_kind="straight",
                        obstacles_s_l=(), v_des=10.0, max_steps=15,
                        goal_arc=100.0, seed=2, noise_on_control=False,
                        device="cpu")
    assert not r.collided
    assert r.ego_trace[-1][0] > 10.0


def test_pid_actuation_lags_direct():
    cfg = to_torch_cfg(tiny("cvar"))
    solver = FrenetSolver(cfg, device="cpu")
    kw = dict(route_kind="straight", obstacles_s_l=(), v_des=10.0, max_steps=12,
              goal_arc=100.0, seed=2, noise_on_control=False, solver=solver)
    r_pid = tcl.run_episode(cfg, actuation="pid", **kw)
    r_dir = tcl.run_episode(cfg, actuation="direct", **kw)
    assert not r_pid.collided
    assert r_pid.ego_trace[-1][0] > 5.0
    assert r_pid.ego_trace[-1][2] < r_dir.ego_trace[-1][2]
    with pytest.raises(ValueError):
        tcl.run_episode(cfg, actuation="throttle", **kw)


def test_cli_runs_episodes_on_the_cpu(capsys):
    results = tcli.main(["--mode", "cvar", "--device", "cpu", "--episodes", "2",
                         "--max_steps", "2", "--num_reduced", "3", "--num_obs",
                         "2", "--num_prime", "20", "--outer_budget", "24x2",
                         "--inner_budget", "16x2", "--obstacles", "40:0.5",
                         "--seed_base", "4"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l["episode"] for l in lines[:2]] == [4, 5]
    assert all(l["steps"] == 2 and l["mean_solve_ms"] > 0 for l in lines[:2])
    assert lines[2] == {"episodes": 2, "collisions": 0, "collision_rate": 0.0}
    assert len(results) == 2 and results[0].obs_trace.shape == (2, 1, 2)


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    """FrenetSolver, build_smoother, run_episode and the CLI run on the card
    unless asked for the CPU: without a card they raise a RuntimeError that
    names the way to the CPU."""
    from mpc_mmd_tpu_torch.frenet import build_smoother
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = to_torch_cfg(tiny("det"))
    for call in (lambda: FrenetSolver(cfg), lambda: build_smoother(50),
                 lambda: tcl.run_episode(cfg, max_steps=1)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--mode", "det", "--max_steps", "1"])
    assert build_smoother(50, device="cpu").kkt_inv.device.type == "cpu"
