"""The solve as one program (``mpc_mmd_tpu_torch/graph.py``) on the CPU: the
noise source's key table, the split of a solve into a host prologue and a
device body, and a graph's replay.

On the card a solver captures its body in a CUDA graph at the first solve
of a key and replays it for every later one (tests/test_torch_gpu.py holds
the replays bit for bit to the eager card solve).  Here the body runs on
the same inputs through :class:`CpuGraphCache`, a ``GraphCache`` whose
"graph" runs the body again on its static input buffers and writes the
static outputs, as a replay of the captured kernels would; so a body that
kept a value of an earlier solve (a seed, ``v_des``, a frame) shows here.
Two successive solves on one solver, every input changed, are each held to
the JAX package's solve of the same inputs as tests/test_torch_prng.py
holds a solve on default noise: the controls (the straight solve's
acceleration and steering, the on-road solve's speed and steering
profiles) within 1e-3, the CEM's traces within rtol 1e-3 + atol 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocking_scenarios
from mpc_mmd_tpu import Solver as JSolver
from mpc_mmd_tpu import frenet as jf
from mpc_mmd_tpu_torch import FrenetSolver as TFrenetSolver
from mpc_mmd_tpu_torch import Solver as TSolver
from mpc_mmd_tpu_torch import frenet as tf
from mpc_mmd_tpu_torch import ops, prng
from mpc_mmd_tpu_torch.graph import Captured, GraphCache
from mpc_mmd_tpu_torch.noise import FixedNoise, JaxNoise, TorchNoise
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from test_torch_frenet import COV0, MEAN0, _scenario, frenet_cfg, jax_solver
from test_torch_noise import jax_draws, to_torch_cfg
from test_torch_solver import COV, INIT, MEAN, _cfg, _controls

torch.set_num_threads(1)


class BodyGraph:
    """A captured graph's stand-in: a replay runs the body on the static
    inputs and writes the static outputs."""

    def __init__(self, body, captured):
        self.body, self.captured = body, captured

    def replay(self):
        for name, t in self.body(**self.captured.inputs).items():
            self.captured.outputs[name].copy_(t)


class CpuGraphCache(GraphCache):
    """``GraphCache`` on the CPU: the first solve of a key loads the static
    inputs and runs the body on them (the warm-up), the "capture" keeps
    static outputs, and every later solve is ``Captured.replay``."""

    def _capture(self, inputs, body):
        captured = Captured(None, {k: torch.empty_like(t) for k, t in inputs.items()})
        captured.load(inputs)
        out = body(**captured.inputs)
        captured.outputs = {k: torch.empty_like(t) for k, t in out.items()}
        captured.graph = BodyGraph(body, captured)
        return out, captured


def _graphed(solver):
    solver._graphs = CpuGraphCache(solver.device)
    return solver


def _ws(js):
    return workspace_from_numpy({n: np.asarray(getattr(js.ws, n)) for n in js.ws._fields},
                                "cpu")


def test_key_table_is_the_jax_key_chain():
    """JaxNoise's key table of a chunk of 3 seeds: every (scenario,
    iteration) holds k_roll, k_steer and k_const, bit-equal to
    ``prng.split``'s chain from PRNGKey(3 idx_mpc + 5 it + 7) and to
    ``jax.random.split``'s; the Frenet solve's initial-state key is
    split(PRNGKey(idx_mpc))[0]."""
    seeds, iters = [3, 11, 40], 4
    table = JaxNoise.keys(seeds, iters)
    assert table.shape == (3, iters, 3, 2) and table.dtype == torch.int64
    for i, s in enumerate(seeds):
        for it in range(iters):
            chain, jchain = [prng.key(3 * s + 5 * it + 7)], [
                jax.random.PRNGKey(3 * s + 5 * it + 7)]
            for _ in range(3):
                chain.append(prng.split(chain[-1])[0])
                jchain.append(jax.random.split(jchain[-1])[0])
            assert torch.equal(table[i, it], torch.stack(chain[1:]))
            assert np.array_equal(table[i, it].numpy(),
                                  np.stack([np.asarray(k) for k in jchain[1:]]))
        assert np.array_equal(JaxNoise.init_key(s).numpy(), np.asarray(
            jax.random.split(jax.random.PRNGKey(s))[0]).astype(np.int64))
    # a scenario's rows do not depend on the chunk it is in
    assert torch.equal(JaxNoise.keys([11], iters)[0], table[1])


def test_two_solves_on_one_solver_each_match_jax():
    """One solver, two solves that change idx_mpc, v_des, the initial
    state, the CEM's mean and the obstacles, the second a replay: each
    within the bars of the module docstring of the JAX solve of its
    inputs (the second's controls move 0.15 with v_des alone, 15 against
    12.5); the first result unchanged after the second."""
    cfg = _cfg(2)
    # an obstacle weight of 1 (1e3 in the presets): at 1e3 the risk hides
    # v_des from the pick, and a stale v_des would not show
    cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, weight_mmd_obs=1.0))
    js = JSolver(cfg)
    ts = _graphed(TSolver(to_torch_cfg(cfg), device="cpu", ws=_ws(js)))
    xts, yts = blocking_scenarios(js.ws.tot_time, 4)
    init2 = INIT + np.asarray([0.0, -0.15, 1.0, 0.0, 0.0, 0.0], np.float32)
    mean2 = MEAN + np.asarray([-1.0] * 4 + [0.0] * 4, np.float32)
    calls = [(42, INIT, MEAN, 15.0, 0), (7, init2, mean2, 12.5, 3)]
    kept = []
    for idx, init, mean, v_des, k in calls:
        xo, yo = np.asarray(xts[k]), np.asarray(yts[k])
        ref = js.solve(idx, jnp.asarray(init), jnp.asarray(mean), jnp.asarray(COV),
                       jnp.asarray(xo), jnp.asarray(yo), v_des)
        got = ts.solve(idx, init, mean, COV, xo, yo, v_des)
        a_r, s_r = _controls(js.ws, cfg, ref.cx, ref.cy)
        a_m, s_m = _controls(js.ws, cfg, jnp.asarray(got.cx.numpy()),
                             jnp.asarray(got.cy.numpy()))
        assert max(np.abs(a_r - a_m).max(), np.abs(s_r - s_m).max()) <= 1e-3
        for name in ("res", "risk_obs", "res_beta", "mean_param"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
        kept.append((got, [t.clone() for t in got]))
    (graph,) = ts._graphs.graphs.values()
    assert graph.replays == 1
    first, copy = kept[0]
    assert all(torch.equal(a, b) for a, b in zip(first, copy))
    assert not torch.equal(first.cx, kept[1][0].cx)


def _second_frame():
    """Another local path than test_torch_frenet's, in both packages, with
    an initial state and obstacles of its own."""
    t = np.linspace(0.0, 1.0, 600)
    x = np.float32(280.0 * t)
    y = np.float32(-6.0 * np.sin(2.0 * np.pi * t) + 12.0 * t * t)
    jframe = jf.path_parameters(jnp.asarray(x), jnp.asarray(y))
    tframe = tf.FrenetFrame(*(torch.from_numpy(np.array(f, np.float32)) for f in jframe))
    ts_ = np.linspace(0.0, 15.0, 100)
    x_obs = np.stack([38.0 + 0.6 * ts_, 52.0 + 0.9 * ts_]).astype(np.float32)
    y_obs = np.stack([-0.4 + 0 * ts_, 2.6 + 0 * ts_]).astype(np.float32)
    psi0 = float(np.arctan2(np.asarray(jframe.Fy_dot)[80], np.asarray(jframe.Fx_dot)[80]))
    init = np.asarray([x[80], y[80] - 0.3, 6.0, 0.1, psi0, 0.0], np.float32)
    return jframe, tframe, init, x_obs, y_obs


def test_two_frenet_steps_on_one_solver_each_match_jax():
    """One FrenetSolver, two steps that change idx_mpc, v_des, the initial
    state, the mean, the obstacles and the frame (every tensor of it), the
    second a replay: each within the bars of the module docstring of the
    JAX Frenet solve of its inputs; the first result unchanged after the
    second."""
    cfg = frenet_cfg("mmd_opt", 2)
    js = jax_solver(cfg)
    ts = _graphed(TFrenetSolver(to_torch_cfg(cfg), device="cpu", ws=_ws(js)))
    mean2 = MEAN0 + np.asarray([1.0] * 4 + [-0.5] * 4, np.float32)
    kept = []
    for idx, mean, v_des, (jframe, tframe, init, xo, yo) in (
            (3, MEAN0, 10.0, _scenario()), (4, mean2, 11.0, _second_frame())):
        ref = js.solve(idx, jnp.asarray(init), jnp.asarray(mean), jnp.asarray(COV0),
                       jnp.asarray(xo), jnp.asarray(yo), v_des, jframe)
        got = ts.solve(idx, init, mean, COV0, xo, yo, v_des, tframe)
        for name in ("v_best", "steering_best"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=0, atol=1e-3, err_msg=name)
        for name in ("risk_obs", "res", "mean_param", "cov_param"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
        kept.append((got, [t.clone() for t in got]))
    (graph,) = ts._graphs.graphs.values()
    assert graph.replays == 1
    first, copy = kept[0]
    assert all(torch.equal(a, b) for a, b in zip(first, copy))


def test_a_graph_is_keyed_by_shapes_and_the_selection(monkeypatch):
    """The cache key: a chunk of another size or another inner-CEM
    selection captures anew; the same shapes replay."""
    monkeypatch.delenv("MPC_MMD_SELECTION", raising=False)
    monkeypatch.delenv("MPC_MMD_FUSED_CEM", raising=False)
    cfg = _cfg(1)
    js = JSolver(cfg)
    ts = _graphed(TSolver(to_torch_cfg(cfg), device="cpu", ws=_ws(js),
                          scenario_chunk=2))
    xts, yts = (np.asarray(a) for a in blocking_scenarios(js.ws.tot_time, 3))
    ts.solve(1, INIT, MEAN, COV, xts[0], yts[0], 15.0)
    ts.solve(2, INIT, MEAN, COV, xts[1], yts[1], 15.0)
    ts.solve_batch([1, 2, 3], INIT, MEAN, COV, xts, yts, 15.0)   # chunks of 2, 1
    monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    ts.solve(3, INIT, MEAN, COV, xts[2], yts[2], 15.0)
    stats = ts.graph_stats()
    assert [s["replays"] for s in stats] == [2, 0, 0]
    assert [{k[0]: k[1] for k in s["key"][:-1]}["keys"][0] for s in stats] == [1, 2, 1]
    assert [s["key"][-1] for s in stats] == [("xla", True), ("xla", True),
                                             ("fused", False)]


def test_a_graphed_solver_refuses_torch_noise_and_what_has_no_graph():
    cfg = to_torch_cfg(_cfg(1))
    with pytest.raises(ValueError, match="graph=False"):
        TSolver(cfg, device="cpu", noise=TorchNoise(torch.Generator(), "cpu"),
                graph=True)
    with pytest.raises(ValueError, match="needs the card"):
        TSolver(cfg, device="cpu", graph=True)
    # the CPU runs eagerly by default, TorchNoise too
    assert not TSolver(cfg, device="cpu").graph
    assert not TSolver(cfg, device="cpu",
                       noise=TorchNoise(torch.Generator(), "cpu")).graph


class FakeGraph:
    """What a replay launches, without a card: the static output is twice
    the static input."""

    def __init__(self, x, y):
        self.x, self.y, self.replays = x, y, 0

    def replay(self):
        self.y.copy_(2.0 * self.x)
        self.replays += 1


def test_a_replay_adds_its_captured_launches_and_clones_its_outputs():
    x, y = torch.zeros(3), torch.zeros(3)
    graph = FakeGraph(x, y)
    captured = Captured(graph, {"x": x}, {"y": y},
                        launches={"topk_indices": 7, "prng_draws": 2})
    saved = ops.launch_counts()
    try:
        ops.reset_launch_counts()
        first = captured.replay({"x": torch.tensor([1.0, 2.0, 3.0])})
        want = {name: 0 for name in saved}
        assert ops.launch_counts() == dict(want, topk_indices=7, prng_draws=2)
        second = captured.replay({"x": torch.tensor([-1.0, 0.5, 4.0])})
        counts = ops.launch_counts()
        assert (counts["topk_indices"], counts["prng_draws"]) == (14, 4)
        assert sum(counts.values()) == 18
    finally:
        ops.set_launch_counts(saved)
    assert torch.equal(first["y"], torch.tensor([2.0, 4.0, 6.0]))
    assert torch.equal(second["y"], torch.tensor([-2.0, 1.0, 8.0]))
    assert first["y"].data_ptr() != y.data_ptr() and graph.replays == 2
    assert captured.replays == 2 and captured.stats()["launches"] == {
        "topk_indices": 7, "prng_draws": 2}


def test_fixed_noise_replays_by_the_iteration_column_of_its_table():
    """FixedNoise's key table holds (idx_mpc, it); a column's draws are
    the iteration's arrays, one set for every scenario, read by an index
    tensor (which a graph replays)."""
    cfg = _cfg(3)
    d = jax_draws(cfg, 0)
    noise = FixedNoise(d, "cpu")
    table = noise.keys([5, 9], 3)
    assert table.tolist()[1] == [[9, 0], [9, 1], [9, 2]]
    eps = noise.rollout_eps(table[:, 2], 4, cfg.horizon.num_prime)
    for e, name in zip(eps, ("eps_acc", "eps_steer", "eps_const")):
        assert np.array_equal(e.numpy(), np.stack([d[name][2]] * 2))
    z = noise.cem_z(table[:, 1], 11, 8)
    assert np.array_equal(z.numpy(), np.stack([d["cem_z"][1]] * 2))


class CountingNoise(JaxNoise):
    """``JaxNoise`` that counts what a solve asks of it."""

    ASKED = ("solve_draws", "rollout_eps", "cem_z", "init_state_z")

    def __init__(self, device):
        super().__init__(device)
        self.asked = dict.fromkeys(self.ASKED, 0)
        for name in self.ASKED:
            setattr(self, name, self._counted(name, getattr(self, name)))

    def _counted(self, name, fn):
        def call(*a, **kw):
            self.asked[name] += 1
            return fn(*a, **kw)
        return call


@pytest.mark.parametrize("road,mode", [("straight", "mmd_opt"), ("straight", "cvar"),
                                       ("frenet", "cvar"), ("frenet", "det")])
def test_a_solve_draws_its_noise_once_and_matches_jax(road, mode):
    """A graphed solve (warm-up and replay) asks its noise source for
    ``solve_draws`` once a solve and for ``rollout_eps``, ``cem_z`` and
    ``init_state_z`` never (kernel (a)'s plan form draws them all on the
    card), and still meets the JAX solve of the same idx_mpc within the
    bars of the module docstring."""
    if road == "straight":
        cfg = _cfg(3).replace(risk=dataclasses.replace(_cfg(3).risk, mode=mode))
        js = JSolver(cfg)
        noise = CountingNoise("cpu")
        ts = _graphed(TSolver(to_torch_cfg(cfg), device="cpu", ws=_ws(js), noise=noise))
        xts, yts = blocking_scenarios(js.ws.tot_time, 2)
        xo, yo = np.asarray(xts[1]), np.asarray(yts[1])
    else:
        cfg = frenet_cfg(mode, 3)
        js = jax_solver(cfg)
        noise = CountingNoise("cpu")
        ts = _graphed(TFrenetSolver(to_torch_cfg(cfg), device="cpu", ws=_ws(js),
                                    noise=noise))
        jframe, tframe, init, xo, yo = _scenario()
    for solves, idx in enumerate((3, 8), 1):
        if road == "straight":
            ref = js.solve(idx, jnp.asarray(INIT), jnp.asarray(MEAN), jnp.asarray(COV),
                           jnp.asarray(xo), jnp.asarray(yo), 15.0)
            got = ts.solve(idx, INIT, MEAN, COV, xo, yo, 15.0)
            a_r, s_r = _controls(js.ws, cfg, ref.cx, ref.cy)
            a_m, s_m = _controls(js.ws, cfg, jnp.asarray(got.cx.numpy()),
                                 jnp.asarray(got.cy.numpy()))
            assert max(np.abs(a_r - a_m).max(), np.abs(s_r - s_m).max()) <= 1e-3
            names = ("res", "risk_obs", "mean_param")
        else:
            ref = js.solve(idx, jnp.asarray(init), jnp.asarray(MEAN0), jnp.asarray(COV0),
                           jnp.asarray(xo), jnp.asarray(yo), 10.0, jframe)
            got = ts.solve(idx, init, MEAN0, COV0, xo, yo, 10.0, tframe)
            for name in ("v_best", "steering_best"):
                np.testing.assert_allclose(getattr(got, name).numpy(),
                                           np.asarray(getattr(ref, name)),
                                           rtol=0, atol=1e-3, err_msg=name)
            names = ("risk_obs", "res", "mean_param", "cov_param")
        for name in names:
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-3, atol=1e-3, err_msg=name)
        assert noise.asked == dict(solve_draws=solves, rollout_eps=0, cem_z=0,
                                   init_state_z=0)
