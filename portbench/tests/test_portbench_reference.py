"""The frozen reference and world: they import nothing of JAX, of the JAX
package or of the port, and the reference gives the port's CPU outputs."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import CHECKOUT, tiny_config

FORBIDDEN = {"jax", "jaxlib", "flax", "mpc_mmd_tpu", "mpc_mmd_tpu_torch"}


@pytest.mark.parametrize("folder", ["reference", "world"])
def test_sources_import_nothing_of_jax_or_the_program(folder):
    for path in (CHECKOUT / "portbench" / folder).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_loading_the_reference_loads_no_module_of_jax_or_the_program():
    code = ("import sys; import portbench.reference.solver, portbench.reference.solver_frenet,"
            " portbench.reference.closedloop, portbench.world;"
            f" print(sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _configs(name):
    from mpc_mmd_tpu_torch import config as port_config
    from portbench.harness.cell import port_problem
    from portbench.reference.config import from_dict
    problem = tiny_config(name)["problem"]
    return port_problem(port_config, problem), from_dict(problem)


def test_reference_solve_equals_the_ports_cpu_solve():
    from mpc_mmd_tpu_torch import Solver
    from portbench import world
    from portbench.reference.solver import Solver as RefSolver
    cfg, ref_cfg = _configs("static_mmd_fastrt")
    x, y = world.static_pool(np.random.default_rng(3), cfg.obstacles.num_obs, cfg.horizon.num, 2)
    init = world.ego_initial_state()
    got = Solver(cfg, device="cpu").solve(2 ** 31 + 5, *init[:3], x[1], y[1], init[3])
    want = RefSolver(ref_cfg, device="cpu").solve(2 ** 31 + 5, *init[:3], x[1], y[1], init[3])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reference_local_problem_and_frenet_solve_equal_the_ports():
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.closedloop import local_problem
    from mpc_mmd_tpu_torch.frenet import build_smoother
    from portbench import world
    from portbench.reference import closedloop as ref_loop
    from portbench.reference.frenet import build_smoother as ref_smoother
    from portbench.reference.solver_frenet import FrenetSolver as RefFrenetSolver
    cfg, ref_cfg = _configs("onroad_mmd")
    plant = world.SyntheticPlant(world.route_spline("curved"), [(30.0, 0.0), (45.0, 1.5)],
                                 cfg.horizon.dt, cfg.vehicle.wheel_base, cfg.obstacles.a_obs,
                                 cfg.obstacles.b_obs)
    plant.step(0.5, 0.01)
    tot = torch.linspace(0, cfg.horizon.t_fin, cfg.horizon.num)
    got = local_problem(cfg, plant, build_smoother(cfg.frenet.num_path, device="cpu"), tot)
    want = ref_loop.local_problem(ref_cfg, plant, ref_smoother(cfg.frenet.num_path, device="cpu"),
                                  tot)
    for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert torch.equal(g, w)
    mean = torch.tensor([15.0] * 4 + [0.0] * 4)
    cov = torch.diag(torch.tensor([20.0] * 4 + [100.0] * 4))
    a = FrenetSolver(cfg, device="cpu").solve(7, got[3], mean, cov, got[1], got[2], 15.0, got[0])
    b = RefFrenetSolver(ref_cfg, device="cpu").solve(7, want[3], mean, cov, want[1], want[2],
                                                     15.0, want[0])
    for g, w in zip(a, b):
        assert torch.equal(g, w)
