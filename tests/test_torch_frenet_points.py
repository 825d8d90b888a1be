"""Kernel (g)'s wrappers (on the CPU their plain versions) against the JAX
package: ``ops.frenet_points`` against global_to_frenet_points,
``ops.frenet_states`` against the JAX solve's noisy initial states and
boundary rows (solver_frenet.py:120-138) on the same draws,
``ops.frenet_obstacles`` against global_to_frenet_obstacle row by row;
the twin of the kernel's tile-pruned search (``nearest_pruned``) against
the chain's argmin (``frenet._nearest``), index for index, on ties,
non-finite inputs, duplicate points and ragged sizes, and as a property
over random paths; and the on-road solver's routes to (g)'s forms, K4n
and kernel (f).

Inputs are made from this file's own seeded numpy generators; both
packages get the same frame (the JAX one's arrays).  Tolerance: s, the arc
length of the nearest path point, exactly (a different nearest point would
differ by a whole interval); the rest at rtol 1e-5 + atol 1e-5, the bar
tests/test_torch_frenet.py holds the conversions to (XLA contracts the
products of the squared distance and of the offset, which the port rounds
apart).  The twin's indices are held to the chain's exactly.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import frenet as jf
from mpc_mmd_tpu_torch import closedloop as tcl
from mpc_mmd_tpu_torch import ops
from mpc_mmd_tpu_torch import frenet as tf
from mpc_mmd_tpu_torch import solver as tsolver
from mpc_mmd_tpu_torch import solver_frenet as tsf
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops import _build
from mpc_mmd_tpu_torch.ops.frenet_points import MAX_STATES, TILE, nearest_pruned
from mpc_mmd_tpu_torch.solver import GlueRoutes
from mpc_mmd_tpu_torch.solver_frenet import FrenetSolver
from mpc_mmd_tpu_torch.utils.kernel_ab import KG_CASES, KG_FULL, kg_case, kg_closedloop
from test_torch_frenet import _curvy_path, _scenario, frenet_cfg, frenet_draws
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


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
    ("mmd_opt", "prefactored", (True, True, True, True)),
    ("cvar", "prefactored", (True, False, True, True)),
    ("saa", "prefactored", (True, False, True, True)),
    ("mmd_random", "prefactored", (True, False, True, True)),
    ("det", "prefactored", (False, False, False, True)),
    ("mmd_opt", "exact", (False, False, False, False))])
def test_glue_routes_of_the_frenet_solver(mode, strategy, routes):
    """The on-road solver reaches K4n and kernel (g) in every mode that rolls
    out, kernel (f) in ``mmd_opt``, (g)'s state form in every mode, and
    keeps the chains under "exact"; ``det`` rolls nothing out."""
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


# ---- the twin of the kernel's tile-pruned search against the chain's argmin ----

CASES = tuple(c for c in KG_CASES if c not in KG_FULL)


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("case", CASES)
def test_pruned_search_equals_the_chains_argmin(case, tile):
    """The twin on ``kernel_ab.kg_case``'s adversarial inputs at three tile
    sizes: the chain's index for every point, the tie rules, the full scan
    on non-finite inputs."""
    frame, px, py = kg_case(case)
    xp, yp = frame.x_path, frame.y_path
    idx, visits = nearest_pruned(frame, px, py, tile=tile)
    ref = tf._nearest(frame, px, py)
    assert torch.equal(idx, ref)
    tiles = -(-xp.shape[0] // tile)
    assert visits.shape == px.shape and int(visits.min()) >= 1 and int(visits.max()) <= tiles
    if case == "tie_across_a_tile_boundary":
        assert idx[:3].tolist() == [31, 15, 63]       # the lower index of the tie
    if case == "tie_between_non_adjacent_tiles":
        assert int(idx[0]) == 10
        if tile == 32:                               # two tiles apart, both visited
            assert int(visits[0]) >= 2
    if case == "squares_overflow":
        assert int(idx[0]) == 0                      # every distance +inf: the first
    if case == "nan_path_point":
        assert (idx == 37).all()                     # a NaN distance ranks first
    finite = bool(torch.isfinite(xp).all() and torch.isfinite(yp).all())
    if not finite:
        assert (visits == tiles).all()               # the full scan everywhere
    if case == "non_finite_query":
        assert (visits[:32] == tiles).all() and (visits[64:] == tiles).all()


def test_pruned_search_property():
    """Over random walks as paths and points around them (snapped to a
    coarse grid where ``snap``, so that ties are common), the twin's index
    is the chain's (a hypothesis property; hypothesis is imported here, so
    that the file's other tests do not need it)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=60, deadline=None, database=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(2, 150),
           points=st.integers(1, 100), scale=st.sampled_from([0.01, 1.0, 300.0]),
           snap=st.booleans())
    def check(seed, n, points, scale, snap):
        rng = np.random.default_rng(seed)
        xp = np.cumsum(rng.normal(0, scale, n)).astype(np.float32)
        yp = np.cumsum(rng.normal(0, scale, n)).astype(np.float32)
        at = rng.integers(0, n, points)
        px = (xp[at] + rng.normal(0, 2 * scale, points)).astype(np.float32)
        py = (yp[at] + rng.normal(0, 2 * scale, points)).astype(np.float32)
        if snap:
            q = np.float32(scale)
            xp, yp, px, py = (np.round(a / q) * q for a in (xp, yp, px, py))
        xp, yp, px, py = (torch.from_numpy(np.asarray(a, np.float32))
                          for a in (xp, yp, px, py))
        frame = tf.FrenetFrame(xp, yp, xp, yp, xp, xp, xp[-1])
        idx, _ = nearest_pruned(frame, px, py)
        assert torch.equal(idx, tf._nearest(frame, px, py))

    check()


@pytest.mark.parametrize("case", KG_FULL)
def test_pruned_search_visits_every_tile_where_nothing_prunes(case):
    """At Path D's 20,000 points: points at the centre of a circular path
    (every tile's bound is the radius squared) and NaN points (the full
    scan) visit every tile, and the twin's index is the chain's."""
    frame, px, py = kg_case(case)
    idx, visits = nearest_pruned(frame, px, py)
    assert torch.equal(idx, tf._nearest(frame, px, py))
    assert (visits == 600 // TILE + 1).all()


def test_pruned_search_visits_few_tiles_along_rollouts():
    """Rollouts of 50 steps from one start along a 600-point path: a warp
    visits a few of the 19 tiles, and the result is the chain's."""
    rng = np.random.default_rng(5)
    s = torch.linspace(0.0, 300.0, 600)
    frame = tf.path_parameters(s, 20.0 * torch.sin(s / 60.0))
    steps = np.cumsum(np.abs(rng.normal(0.5, 0.1, (100, 4, 50))), axis=-1) + 40.0
    x = torch.from_numpy(steps.astype(np.float32))
    y = 20.0 * torch.sin(x / 60.0) + torch.from_numpy(
        rng.normal(0, 1.0, (100, 4, 1)).astype(np.float32))
    idx, visits = nearest_pruned(frame, x, y)
    assert torch.equal(idx.reshape(-1), tf._nearest(frame, x.reshape(-1), y.reshape(-1)))
    assert float(visits.float().mean()) <= 6.0 and int(visits.max()) < 19


@pytest.mark.parametrize("form", ["points", "states", "obstacles"])
def test_each_form_probes_the_same_way(form):
    """Every form's wrapper takes ``probe``: on the CPU its plain outputs
    followed by the twin's nearest indices and visited tiles (int32), at
    the points the form converts; without it the plain outputs alone."""
    from mpc_mmd_tpu_torch.config import onroad_workload
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_state_inputs
    cfg = onroad_workload()
    gen = torch.Generator().manual_seed(3)
    (frame, x, y), obs = kg_closedloop(gen, cfg)
    if form == "points":
        call, at = (lambda **k: ops.frenet_points(frame, x, y, **k)), (x, y)
    elif form == "obstacles":
        call, at = (lambda **k: ops.frenet_obstacles(frame, obs, **k)), (obs[:, 0], obs[:, 1])
    else:
        args = kg_state_inputs(gen, cfg, frame, 16)
        call, at = (lambda **k: ops.frenet_states(*args, **k)), None
    plain = call()
    *out, idx, visits = call(probe=True)
    assert len(out) == len(plain) and all(torch.equal(g, r) for g, r in zip(out, plain))
    if at is None:
        at = (plain[0][:, 0], plain[0][:, 1])
    tidx, tvisits = nearest_pruned(frame, *at)
    assert idx.dtype == visits.dtype == torch.int32
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)
    assert torch.equal(idx.long(), tf._nearest(frame, at[0].reshape(-1),
                                               at[1].reshape(-1)).view(at[0].shape))


def test_the_twin_and_the_kernel_share_the_tile():
    src = (_build.CSRC / "frenet_points.cu").read_text()
    assert re.search(rf"constexpr int kTile = {TILE};", src)
    assert re.search(rf"constexpr int kStateThreads = {MAX_STATES};", src)


def test_the_longest_path_fits_the_kernels_tile_masks():
    """The wrappers' MAX_PATH in tiles fits the search's need masks
    (kMaxTiles, whole words of 32), which the launchers also check."""
    from mpc_mmd_tpu_torch.ops.frenet_points import MAX_PATH
    src = (_build.CSRC / "frenet_points.cu").read_text()
    most = int(re.search(r"constexpr int kMaxTiles = (\d+);", src).group(1))
    assert most % 32 == 0 and -(-MAX_PATH // TILE) <= most
    assert src.count("tiles_of(pa.n) > kMaxTiles") == 2


def test_kernel_ab_calls_an_earlier_kg_entry_without_the_probe():
    """kernel_ab's (g) builds of an earlier source, whose mmd_frenet_points
    lacks the probe's idx and visits: the current entry has them at
    KG_PROBE_AT, and EarlierEntry drops exactly those two arguments."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import KG_PROBE, KG_PROBE_AT, EarlierEntry
    src = (_build.CSRC / "frenet_points.cu").read_text()
    entry = src[src.index('extern "C" int mmd_frenet_points('):]
    assert KG_PROBE in entry[:entry.index("{")]
    assert len(_build._SIGNATURES["mmd_frenet_points"]) == 15

    class Lib:
        def mmd_frenet_points(self, *args):
            return args

    args = tuple(range(15))
    got = EarlierEntry(Lib(), "mmd_frenet_points", KG_PROBE_AT).mmd_frenet_points(*args)
    assert got == tuple(a for a in args if a not in (9, 10))


# ---- the state form and the obstacle form against the JAX package ----

def _jax_initial_states(cfg, jframe, z, init):
    """The JAX solve's noisy initial states and boundary rows
    (mpc_mmd_tpu/solver_frenet.py:120-138) on the standard normals z."""
    x_g, y_g, v_g, vdot_g, psi_g, psidot_g = [init[i] for i in range(6)]
    vx, vy = v_g * jnp.cos(psi_g), v_g * jnp.sin(psi_g)
    n, (mu, sig) = z.shape[0], (cfg.frenet.init_mu, cfg.frenet.init_sigma)
    xs = x_g + z[:, 0] * sig[0] + mu[0]
    ys = y_g + z[:, 1] * sig[1] + mu[1]
    ones = jnp.ones(n)
    temps = jnp.stack([xs, ys, jnp.sqrt((vx * ones) ** 2 + (vy * ones) ** 2),
                       vdot_g * ones, jnp.arctan2(vy, vx) * ones, psidot_g * ones], axis=1)
    conv = jax.vmap(lambda s: jf.global_to_frenet_state(jframe, s))(temps)
    m = [c.mean() for c in conv[:6]]
    nb1 = jnp.ones((cfg.cem.num_batch, 1))
    states = jnp.stack((xs, ys, vx * ones, vy * ones, jnp.arctan2(vy, vx) * ones), axis=1)
    return (states, jnp.concatenate((m[0] * nb1, m[2] * nb1, m[4] * nb1), axis=1),
            jnp.concatenate((m[1] * nb1, m[3] * nb1, m[5] * nb1, 0 * nb1), axis=1), conv)


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar", "det", "wide"])
def test_frenet_states_matches_jax(mode):
    """The state form's wrapper (its plain version on the CPU) at the
    mode's number of states (R^2 = 9, R = 3, 1, and 100) against the JAX
    solve's rows on the same draws; each state's s exactly."""
    cfg = frenet_cfg("mmd_opt" if mode == "wide" else mode, 1)
    jframe, tframe, init, _, _ = _scenario()
    n = {"mmd_opt": 9, "cvar": 3, "det": 1, "wide": 100}[mode]
    z = np.random.default_rng(11).normal(0, 1, (n, 4)).astype(np.float32)
    tcfg = to_torch_cfg(cfg)
    got = ops.frenet_states(tframe, torch.from_numpy(z), torch.from_numpy(init),
                            tcfg.frenet.init_mu, tcfg.frenet.init_sigma, cfg.cem.num_batch)
    *ref, conv = _jax_initial_states(cfg, jframe, jnp.asarray(z), jnp.asarray(init))
    for g, r, shape in zip(got, ref, ((n, 5), (cfg.cem.num_batch, 3),
                                      (cfg.cem.num_batch, 4))):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    temps = torch.cat((got[0][:, :2], torch.sqrt(got[0][:, 2:3] ** 2 + got[0][:, 3:4] ** 2),
                       torch.full((n, 1), float(init[3])), got[0][:, 4:5],
                       torch.full((n, 1), float(init[5]))), dim=1)
    s = tf.global_to_frenet_state(tframe, temps)[0]
    np.testing.assert_array_equal(s.numpy(), np.asarray(conv[0]))


def test_frenet_obstacles_matches_jax():
    jframe, tframe = _frames(*_curvy_path())
    rng = np.random.default_rng(13)
    obs = np.stack([rng.uniform(0, 300, 7), rng.uniform(-5, 30, 7), rng.normal(3, 2, 7),
                    rng.normal(0, 1, 7), rng.uniform(-3, 3, 7)], axis=1).astype(np.float32)
    obs[0] = (500.0, 500.0, 0.0, 0.0, 0.0)          # perception's far-away dummy
    got = ops.frenet_obstacles(tframe, torch.from_numpy(obs))
    assert len(got) == 5 and all(tuple(g.shape) == (7,) for g in got)
    for i, row in enumerate(obs):
        ref = jf.global_to_frenet_obstacle(jframe, *[jnp.float32(v) for v in row])
        assert float(got[0][i]) == float(ref[0])
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(float(g[i]), float(r), **TOL)


def test_state_and_obstacle_forms_reject_bad_shapes():
    _, tframe = _frames(*_steps_path(20))
    with pytest.raises(ValueError):
        ops.frenet_states(tframe, torch.zeros(3, 2), torch.zeros(6), (0, 0), (1, 1), 4)
    with pytest.raises(ValueError):
        ops.frenet_states(tframe, torch.zeros(3, 4), torch.zeros(5), (0, 0), (1, 1), 4)
    with pytest.raises(ValueError):
        ops.frenet_obstacles(tframe, torch.zeros(3, 4))
    with pytest.raises(ValueError):
        ops.frenet_obstacles(tframe._replace(kappa=tframe.kappa[:-1]), torch.zeros(3, 5))


@pytest.mark.parametrize("mode,strategy", [
    ("mmd_opt", "prefactored"), ("cvar", "prefactored"), ("saa", "prefactored"),
    ("mmd_random", "prefactored"), ("det", "prefactored"), ("mmd_opt", "exact")])
def test_a_frenet_solve_forms_its_initial_states_once(monkeypatch, mode, strategy):
    """A CPU on-road solve forms its noisy initial states and boundary rows
    through the state form's wrapper once (its plain version here) in every
    prefactored mode, ``det`` included, and through the chain under
    "exact"."""
    cfg = frenet_cfg(mode, 1).replace(solve_strategy=strategy)
    calls = dict.fromkeys(("frenet_states", "initial_states"), 0)
    for name in calls:
        fn = getattr(tsf, name)

        def call(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tsf, name, call)
    _, tframe, init, xo, yo = _scenario()
    solver = FrenetSolver(to_torch_cfg(cfg), device="cpu",
                          noise=FixedNoise(frenet_draws(cfg, 3), "cpu"))
    solver.solve(3, init, [10.0] * 4 + [1.75] * 4, np.diag([20.0] * 4 + [100.0] * 4), xo,
                 yo, 10.0, tframe)
    kernel = strategy == "prefactored"
    assert calls == {"frenet_states": int(kernel), "initial_states": int(not kernel)}


def test_local_problem_converts_its_obstacles_through_the_obstacle_form(monkeypatch):
    from mpc_mmd_tpu_torch.config import onroad_workload
    cfg = onroad_workload(num_reduced=3, num_obs=2, num_prime=20)
    seen = []

    def call(frame, obs, **kw):
        seen.append(tuple(obs.shape))
        return ops.frenet_obstacles(frame, obs, **kw)
    monkeypatch.setattr(tcl, "frenet_obstacles", call)
    plant = tcl.SyntheticPlant(cfg, tcl.make_route("curved"), ((60.0, 0.0), (140.0, 1.5)))
    tot = torch.linspace(0, cfg.horizon.t_fin, cfg.horizon.num)
    frame, x_obs, y_obs, _ = tcl.local_problem(
        cfg, plant, tf.build_smoother(cfg.frenet.num_path, device="cpu"), tot)
    assert seen == [(cfg.obstacles.num_obs, 5)]
    assert tuple(x_obs.shape) == (cfg.obstacles.num_obs, cfg.horizon.num)


def test_pruned_search_on_a_closed_loop_frame():
    """``kernel_ab.kg_closedloop``: local_problem's frame 150 m along the
    curved route and Path D's 400 rollouts from the ego: the twin's index
    is the chain's, the warps visit a few tiles, and the obstacle rows are
    local_problem's shape."""
    from mpc_mmd_tpu_torch.config import onroad_workload
    cfg = onroad_workload()
    gen = torch.Generator().manual_seed(0)
    (frame, x, y), obs = kg_closedloop(gen, cfg)
    assert tuple(x.shape) == (1, cfg.cem.num_batch, cfg.risk.num_reduced,
                              cfg.horizon.num_prime)
    idx, visits = nearest_pruned(frame, x, y)
    assert torch.equal(idx.reshape(-1), tf._nearest(frame, x.reshape(-1), y.reshape(-1)))
    assert float(visits.float().mean()) < 600 // TILE
    assert tuple(obs.shape) == (cfg.obstacles.num_obs, 5)
