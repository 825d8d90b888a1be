"""Kernel (f)'s wrapper (``ops.inner_prologue``; on the CPU its plain
version) against the JAX package's refit and distance matrices, the plain
chain's symmetry at the paths' shapes, the kernel's launch shape, the
solver's routes to (f) and K4n, and the hoisted inner-CEM inputs.

Inputs are made from a seed with numpy.  Tolerances: the coefficients at
rtol 1e-4 + atol 1e-3 of the JAX refit, the bar tests/test_torch_qp.py
holds ``qp.refit_coefficients`` to (two float32 products summed in
another order by XLA); D and D2 at rtol 1e-5 + atol 1e-3, the bar of
tests/test_torch_risk.py's pairwise distances, plus the coefficients'
own gap carried through a sum of 2 nvar terms.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import kernels as jk
from mpc_mmd_tpu import qp as jqp
from mpc_mmd_tpu_torch import ops, reduced_set
from mpc_mmd_tpu_torch import solver as tsolver
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops.inner_prologue import inner_prologue_plain
from mpc_mmd_tpu_torch.qp import build_workspace
from mpc_mmd_tpu_torch.solver import GlueRoutes, Solver
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)

C, M, T = 3, 12, 15


def _rollouts(seed):
    rng = np.random.default_rng(seed)
    t = 0.15 * np.arange(T)
    v = rng.uniform(5, 15, (1, C, M, 1))
    x = (v * t + np.cumsum(rng.normal(0, 0.05, (1, C, M, T)), axis=-1)).astype(np.float32)
    y = (rng.normal(0, 1.75, (1, C, M, 1))
         + np.cumsum(rng.normal(0, 0.05, (1, C, M, T)), axis=-1)).astype(np.float32)
    x[0, 0, 3] = x[0, 0, 2]            # two equal rollouts: a zero distance
    y[0, 0, 3] = y[0, 0, 2]
    return x, y


@pytest.mark.parametrize("kind", ["laplace", "gaussian", "matern52"])
def test_inner_prologue_matches_jax_refit_and_distances(kind):
    cfg = jc.static_workload(num_reduced=4, num_prime=T)
    jws = jqp.build_workspace(cfg)
    tws = build_workspace(to_torch_cfg(cfg), device="cpu")
    x, y = _rollouts(1)
    before = ops.inner_prologue.launches
    got = ops.inner_prologue(tws, torch.from_numpy(x), torch.from_numpy(y), kind)
    assert ops.inner_prologue.launches == before     # CPU tensors take the plain version
    jcx, jcy = jqp.refit_coefficients(jws, jnp.asarray(x.reshape(-1, T)),
                                      jnp.asarray(y.reshape(-1, T)))
    nvar = cfg.horizon.nvar
    jcx, jcy = (np.asarray(c).reshape(C, M, nvar) for c in (jcx, jcy))
    np.testing.assert_allclose(got.cx.numpy(), jcx, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got.cy.numpy(), jcy, rtol=1e-4, atol=1e-3)
    feats = jnp.concatenate((jnp.asarray(jcx), jnp.asarray(jcy)), axis=2)
    np.testing.assert_allclose(got.D.numpy(), np.asarray(jk.pairwise_l1(feats, feats)),
                               rtol=1e-5, atol=1e-3)
    assert float(got.D[0, 2, 3]) == 0.0
    if kind == "laplace":
        assert got.D2 is None
    else:
        np.testing.assert_allclose(got.D2.numpy(),
                                   np.asarray(jk.pairwise_l2sq(feats, feats)),
                                   rtol=1e-5, atol=1e-3)
        assert float(got.D2.min()) >= 0.0


def test_inner_prologue_plain_is_the_solver_chain():
    """The plain version is the refit and the distances as the chain ran
    them inside the solve: bit for bit on the CPU, at two scenarios."""
    cfg = to_torch_cfg(jc.static_workload(num_reduced=4, num_prime=T))
    ws = build_workspace(cfg, device="cpu")
    x, y = (torch.from_numpy(np.concatenate([a, b]))
            for a, b in zip(_rollouts(2), _rollouts(3)))
    got = inner_prologue_plain(ws, x, y, "gaussian")
    cx, cy = tsolver.refit_coefficients(ws, x.reshape(-1, T), y.reshape(-1, T), 2)
    feats = torch.cat((cx, cy), dim=1).reshape(2 * C, M, -1)
    assert torch.equal(got.cx, cx.reshape(2 * C, M, -1))
    assert torch.equal(got.D, torch.sum(torch.abs(feats[:, :, None] - feats[:, None]), -1))
    assert torch.equal(got.D2, reduced_set.distance_matrices(got.cx, got.cy, "gaussian")[1])


def test_inner_prologue_rejects_bad_shapes():
    cfg = to_torch_cfg(jc.static_workload(num_reduced=4, num_prime=T))
    ws = build_workspace(cfg, device="cpu")
    x = torch.zeros(1, C, M, T)
    with pytest.raises(ValueError):
        ops.inner_prologue(ws, x, torch.zeros(1, C, M, T + 1), "laplace")
    with pytest.raises(ValueError):
        ops.inner_prologue(ws, x[0], x[0], "laplace")
    with pytest.raises(ValueError):
        ops.inner_prologue(ws, torch.zeros(1, C, M, T - 1), torch.zeros(1, C, M, T - 1),
                           "laplace")


@pytest.mark.parametrize("M,seed", [(100, 5), (16, 6), (225, 7)])
def test_plain_distances_are_bit_symmetric_and_match_jax(M, seed):
    """At fastrt's, Path D's and F15's mother rollouts (M = 100, 16, 225;
    T = 50, nvar 11) the plain chain's D and D2 are exactly symmetric, the
    property kernel (f) rests on to compute each unordered pair once, and
    D is JAX's pairwise_l1 of the same features at the file's tolerance."""
    rng = np.random.default_rng(seed)
    T_, nvar = 50, 11
    cfg = jc.fastrt_workload(num_reduced=4, num_prime=T_)
    ws = build_workspace(to_torch_cfg(cfg), device="cpu")
    t = 0.3 * np.arange(T_)
    v = rng.uniform(5, 15, (1, 2, M, 1))
    x = (v * t + np.cumsum(rng.normal(0, 0.05, (1, 2, M, T_)), axis=-1)).astype(np.float32)
    y = (rng.normal(0, 1.75, (1, 2, M, 1))
         + np.cumsum(rng.normal(0, 0.05, (1, 2, M, T_)), axis=-1)).astype(np.float32)
    got = inner_prologue_plain(ws, torch.from_numpy(x), torch.from_numpy(y), "gaussian")
    assert got.cx.shape == (2, M, nvar)
    for mat in (got.D, got.D2):
        assert torch.equal(mat, mat.transpose(1, 2))
    feats = np.concatenate((got.cx.numpy(), got.cy.numpy()), axis=2)
    np.testing.assert_allclose(got.D.numpy(), np.asarray(jk.pairwise_l1(feats, feats)),
                               rtol=1e-5, atol=1e-3)


# every path's (candidates a launch, M): fastrt x 1, 4, 8 (E1, E4, E8),
# Path A x 1, 4 (A, EA4), Path D, F5, F15 and 11a's chunk of 32
PATH_SHAPES = [(64, 100), (256, 100), (512, 100), (100, 100), (400, 100), (100, 16),
               (100, 25), (100, 225), (2048, 100)]


@pytest.mark.parametrize("B,M", PATH_SHAPES)
def test_launch_shape_at_every_path_shape(B, M):
    """Kernel (f)'s cluster at H100's 132 multiprocessors: two CTAs a
    candidate where two a candidate still fit one a multiprocessor, else
    one; within 227 KB of shared memory a CTA, and at every path shape at
    least two CTAs an SM (M = 225 included: no CTA holds an SM alone)."""
    from mpc_mmd_tpu_torch.ops.inner_prologue import (CLUSTERS, MAX_SMEM, launch_shape,
                                                      smem_bytes)
    cs = launch_shape(B, M, 50, 11, 132)
    assert cs in CLUSTERS
    assert cs == (2 if 2 * B <= 132 else 1)
    assert 2 * (smem_bytes(M, 50, 11, cs) + 1024) <= 228 * 1024 <= MAX_SMEM + 1024


def test_launch_shape_values_and_smem():
    from mpc_mmd_tpu_torch.ops.inner_prologue import launch_shape, smem_bytes
    assert [launch_shape(B, M, 50, 11, 132) for B, M in PATH_SHAPES] == [
        2, 1, 1, 1, 1, 1, 1, 1, 1]
    # fastrt at one CTA a candidate: an mbarrier, 2 x 100 x 50 staged
    # floats (+ 4 each), 100 x 24 features, P (50 x 12), Rinv (11 x 12), aa
    assert smem_bytes(100, 50, 11, 1) == 4 * (4 + 2 * 5004 + 2400 + 600 + 132 + 100)
    # Path D at two: the warps' row buffers (8 x 32 x 9) outgrow 2 x 8
    # staged rows
    assert smem_bytes(16, 50, 11, 2) == 4 * (4 + 2304 + 16 * 24 + 600 + 132 + 16)
    # F15: two CTAs an SM (1 KB of each CTA's is the card's own) at one CTA
    # a candidate, three at two
    one, two = (smem_bytes(225, 50, 11, c) + 1024 for c in (1, 2))
    assert 3 * one > 228 * 1024 >= 2 * one and 3 * two <= 228 * 1024


def test_launch_shape_refusals():
    from mpc_mmd_tpu_torch.ops.inner_prologue import launch_shape
    with pytest.raises(ValueError):
        launch_shape(64, 100, 50, 17, 132)          # nvar past 16
    with pytest.raises(ValueError):
        launch_shape(64, 2000, 50, 11, 132)         # features past 227 KB a CTA
    assert launch_shape(256, 900, 50, 11, 132) == 4  # one and two CTAs do not fit


def _cfg(mode="mmd_opt", **kw):
    cfg = jc.fastrt_workload(num_reduced=3, num_obs=2, num_prime=15, mode=mode, **kw)
    return cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=16, ellite_num=4,
                                               ellite_num_cost=8, maxiter_cem=2),
                       beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12,
                                                    maxiter=2))


class _Mesh:
    world, rank = 2, 0


@pytest.mark.parametrize("make,routes", [
    (lambda: Solver(to_torch_cfg(_cfg()), device="cpu"), (True, True, False)),
    (lambda: Solver(to_torch_cfg(_cfg(noise="beta", noise_level=0.2)), device="cpu"),
     (True, True, False)),
    (lambda: Solver(to_torch_cfg(_cfg("cvar")), device="cpu"), (True, False, False)),
    (lambda: Solver(to_torch_cfg(_cfg("saa")), device="cpu"), (True, False, False)),
    (lambda: Solver(to_torch_cfg(_cfg("mmd_random")), device="cpu"), (True, False, False)),
    (lambda: Solver(to_torch_cfg(_cfg().replace(solve_strategy="exact")), device="cpu"),
     (False, False, False)),
    (lambda: Solver(to_torch_cfg(_cfg()), device="cpu", candidate_mesh=_Mesh()),
     (False, False, False))])
def test_glue_routes_of_the_solver(make, routes):
    """Which configurations of ``Solver`` reach K4n (every prefactored mode)
    and kernel (f) (``mmd_opt``), and which keep their chains ("exact", a
    candidate mesh of several ranks); kernel (g) is the on-road solver's."""
    assert make()._glue_routes() == GlueRoutes(*routes)


def _counting(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def call(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, call)
    return calls


@pytest.mark.parametrize("mode,strategy,want", [
    ("mmd_opt", "prefactored", {"noisy_rollout": 2, "inner_prologue": 2,
                                "noisy_controls": 0, "refit_coefficients": 0}),
    ("cvar", "prefactored", {"noisy_rollout": 2, "inner_prologue": 0,
                             "noisy_controls": 0, "refit_coefficients": 0}),
    ("mmd_opt", "exact", {"noisy_rollout": 0, "inner_prologue": 0,
                          "noisy_controls": 2, "refit_coefficients": 2})])
def test_a_solve_calls_the_glue_wrappers_once_an_outer_iteration(monkeypatch, mode,
                                                                 strategy, want):
    """A CPU solve goes through K4n's and kernel (f)'s wrappers (their plain
    versions here) once an outer iteration where the routes send it, and
    through the chain under "exact"; the solve's result is that of the
    chain, bit for bit."""
    cfg = _cfg(mode).replace(solve_strategy=strategy)
    calls = _counting(monkeypatch, tsolver, list(want))
    t = np.linspace(0, 15, cfg.horizon.num)
    args = ([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
            np.diag([20.0] * 4 + [100.0] * 4), np.stack([10 + t, 16 + t]).astype(np.float32),
            np.stack([0 * t + 1.5, 0 * t]).astype(np.float32), 15.0)
    make = lambda: Solver(to_torch_cfg(cfg), device="cpu",
                          noise=FixedNoise(jax_draws(cfg, 0), "cpu"))
    r = make().solve(0, *args)
    assert calls == want
    monkeypatch.setattr(Solver, "_glue_routes", lambda s: GlueRoutes(False, False, False))
    ref = make().solve(0, *args)
    for g, e in zip(r, ref):
        assert torch.equal(g, e)


@pytest.mark.parametrize("kind", ["laplace", "matern52"])
def test_hoisted_inner_inputs_equal_the_per_iteration_ones(kind):
    """The solver's inner-CEM inputs made once beside its draws
    (``SolverSetup._inner_fixed``) are those ``reduced_set.inner_inputs``
    makes from the same draws, bit for bit."""
    cfg = _cfg()
    cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kind))
    s = Solver(to_torch_cfg(cfg), device="cpu", noise=FixedNoise(jax_draws(cfg, 0), "cpu"))
    rng = np.random.default_rng(4)
    M_ = cfg.risk.num_mother
    cx, cy = (torch.from_numpy(rng.normal(0, 3, (5, M_, cfg.horizon.nvar)).astype(np.float32))
              for _ in range(2))
    per_iteration = reduced_set.inner_inputs(s.cfg, cx, cy, s._inner)
    for name, hoisted in s._inner_fixed._asdict().items():
        assert torch.equal(hoisted, getattr(per_iteration, name)), name
    D, D2 = reduced_set.distance_matrices(cx, cy, kind)
    assert torch.equal(per_iteration.D, D)
    assert (D2 is None) == (kind == "laplace")
