"""Kernel (g)'s wrapper (``ops.frenet_points``; on the CPU its plain version,
``frenet.global_to_frenet_points``) against the JAX package's
global_to_frenet_points, and the on-road solver's routes to (g), K4n and
kernel (f).

Inputs are made from a seed with numpy; both packages get the same frame
(the JAX one's arrays).  Tolerance: s, the arc length of the nearest path
point, exactly (a different nearest point would differ by a whole
interval); l at rtol 1e-5 + atol 1e-5, the bar tests/test_torch_frenet.py
holds the conversions to (XLA contracts the products of the squared
distance and of the offset, which the port rounds apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import frenet as jf
from mpc_mmd_tpu_torch import ops
from mpc_mmd_tpu_torch import frenet as tf
from mpc_mmd_tpu_torch import solver as tsolver
from mpc_mmd_tpu_torch import solver_frenet as tsf
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.solver import GlueRoutes
from mpc_mmd_tpu_torch.solver_frenet import FrenetSolver
from test_torch_frenet import _curvy_path, _scenario, frenet_cfg, frenet_draws
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)


def _frames(x, y):
    jframe = jf.path_parameters(jnp.asarray(x), jnp.asarray(y))
    return jframe, tf.FrenetFrame(*(torch.from_numpy(np.array(f, np.float32))
                                    for f in jframe))


def _steps_path(n=200):
    """A path of exact float32 coordinates: x the indices, y a staircase of
    quarter metres, so that a point between two path points is exactly as
    far from both."""
    i = np.arange(n)
    return i.astype(np.float32), (0.25 * (i // 7)).astype(np.float32)


def _points(rng, x_path, y_path, shape=(1, 3, 4, 15)):
    """Points around the path, with edge points in the first row: one
    equidistant from path points 10 and 11, one before the path's start,
    one past its end, one on the last path point and one nearest it."""
    n = len(x_path)
    at = rng.integers(0, n, shape)
    x = (x_path[at] + rng.normal(0, 0.4, shape)).astype(np.float32)
    y = (y_path[at] + rng.normal(0, 2.0, shape)).astype(np.float32)
    edge = [((x_path[10] + x_path[11]) / 2, (y_path[10] + y_path[11]) / 2 + 0.75),
            (x_path[0] - 3.0, y_path[0] + 0.5), (x_path[-1] + 4.0, y_path[-1] - 0.3),
            (x_path[-1], y_path[-1]), (x_path[-1] - 0.1, y_path[-1] + 0.2)]
    for k, (ex, ey) in enumerate(edge):
        x[0, 0, 0, k], y[0, 0, 0, k] = ex, ey
    return x, y


@pytest.mark.parametrize("path", ["curvy", "steps"])
def test_frenet_points_matches_jax(path):
    rng = np.random.default_rng(7)
    xp, yp = _curvy_path() if path == "curvy" else _steps_path()
    jframe, tframe = _frames(xp, yp)
    x, y = _points(rng, np.asarray(jframe.x_path), np.asarray(jframe.y_path))
    before = ops.frenet_points.launches
    s, l = ops.frenet_points(tframe, torch.from_numpy(x), torch.from_numpy(y))
    assert ops.frenet_points.launches == before    # CPU tensors take the plain version
    js, jl = jf.global_to_frenet_points(jframe, jnp.asarray(x), jnp.asarray(y))
    assert s.shape == x.shape
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    arc = np.asarray(jframe.arc_vec)
    first = s[0, 0, 0].numpy()
    if path == "steps":
        assert first[0] == arc[10]                 # the tie goes to the lower index
    assert first[1] == arc[0] and first[2] == arc[-1]
    assert first[3] == arc[-1] and first[4] == arc[-1]
    assert float(l[0, 0, 0, 3]) == 0.0


def test_frenet_points_rejects_bad_shapes():
    _, tframe = _frames(*_steps_path(20))
    with pytest.raises(ValueError):
        ops.frenet_points(tframe, torch.zeros(3, 4), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        ops.frenet_points(tframe._replace(arc_vec=tframe.arc_vec[:-1]), torch.zeros(3),
                          torch.zeros(3))


@pytest.mark.parametrize("mode,strategy,routes", [
    ("mmd_opt", "prefactored", (True, True, True)),
    ("cvar", "prefactored", (True, False, True)),
    ("saa", "prefactored", (True, False, True)),
    ("mmd_random", "prefactored", (True, False, True)),
    ("det", "prefactored", (False, False, False)),
    ("mmd_opt", "exact", (False, False, False))])
def test_glue_routes_of_the_frenet_solver(mode, strategy, routes):
    """The on-road solver reaches K4n and kernel (g) in every mode that rolls
    out, kernel (f) in ``mmd_opt``, and keeps the chains under "exact";
    ``det`` rolls nothing out."""
    cfg = frenet_cfg(mode, 1).replace(solve_strategy=strategy)
    assert FrenetSolver(to_torch_cfg(cfg), device="cpu")._glue_routes() == GlueRoutes(*routes)


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar"])
def test_a_frenet_solve_calls_kernel_g_once_an_outer_iteration(monkeypatch, mode):
    """A CPU on-road solve converts its rollouts through kernel (g)'s
    wrapper (its plain version here) and rolls out through K4n's once an
    outer iteration, and its result is the chains' bit for bit."""
    cfg = frenet_cfg(mode, 2)
    calls = dict.fromkeys(("frenet_points", "noisy_rollout", "global_to_frenet_points"), 0)
    for name in calls:
        module = tsolver if name == "noisy_rollout" else tsf
        fn = getattr(module, name)

        def call(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, call)
    _, tframe, init, xo, yo = _scenario()
    make = lambda: FrenetSolver(to_torch_cfg(cfg), device="cpu",
                                noise=FixedNoise(frenet_draws(cfg, 3), "cpu"))
    args = (3, init, [10.0] * 4 + [1.75] * 4, np.diag([20.0] * 4 + [100.0] * 4), xo, yo,
            10.0, tframe)
    r = make().solve(*args)
    assert calls == {"frenet_points": 2, "noisy_rollout": 2, "global_to_frenet_points": 0}
    monkeypatch.setattr(FrenetSolver, "_glue_routes", lambda s: GlueRoutes(False, False, False))
    ref = make().solve(*args)
    assert calls["global_to_frenet_points"] == 2
    for g, e in zip(r, ref):
        assert torch.equal(g, e)
