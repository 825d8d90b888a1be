"""Kernel (h)'s wrapper ``ops.local_frame`` (on the CPU its plain version,
the chain ``frenet.path_parameters(*frenet.smooth_path(...))``) and its twin
``local_frame_twin`` (the kernel's algorithm in tensors: the products in
cuBLAS's gemv order, the cumulative sum in CUB's scan order) against the
JAX package's ``smooth_path`` + ``path_parameters``
(mpc_mmd_tpu/frenet.py:111, :148); the twin's building blocks; and
``closedloop.local_problem``'s routes through (h) and (g)'s obstacle form.

Inputs are ``utils/kernel_ab.kh_window``'s, which chip_smoke.py and the
card's tests take too: windows of the curved, straight and circuit routes
(``closedloop.make_route``) at three ego positions jittered by a seeded
numpy generator, at num_path 600 and 64, and maxiter 1 and 10.
Tolerances against the JAX package: the positions at rtol 1e-6 + atol 1e-4
(``tests/test_torch_frenet.py::test_spline_window_and_smoothing_match_jax``:
ten rounds of 601-term float32 dot products summed in another order, over
a 300 m window whose float32 ulp is 3e-5), and arc_vec the same; the
tangents Fx_dot, Fy_dot (differences of two positions) at rtol 1e-6 + atol
3e-4; kappa at rtol 1e-6 and an atol of each route and width, about twice
the largest difference over its windows (for the twin or the port's
chain): its numerator is a second difference of the positions, divided by
|F'|^3, about 0.125 at num_path 600, so on the curved and circuit routes
at num_path 600 the largest was 3.9e-4 (atol 8e-4, |kappa| up to 5.8e-2),
at num_path 64 2.9e-6 (atol 1e-5); the straight route's kappa is round-off
(|kappa| at most 9.5e-7 in the JAX package's frame, the largest difference
as much: atol 4e-6).  The wrapper on CPU tensors is the chain, bit for bit.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import frenet as jf
from mpc_mmd_tpu_torch import closedloop as tcl
from mpc_mmd_tpu_torch import frenet as tf
from mpc_mmd_tpu_torch import ops
from mpc_mmd_tpu_torch.config import onroad_workload
from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
from mpc_mmd_tpu_torch.ops.local_frame import (STRIDED_FROM, cub_cumsum, fma32, gemv_rows,
                                               local_frame, local_frame_twin)
from mpc_mmd_tpu_torch.utils.kernel_ab import KH_AT, KH_ROUNDS, KH_ROUTES, KH_WIDTHS, kh_window

torch.set_num_threads(1)

POS = dict(rtol=1e-6, atol=1e-4)
TOL = {"x_path": POS, "y_path": POS, "arc_vec": POS, "arc_length": POS,
       "Fx_dot": dict(rtol=1e-6, atol=3e-4), "Fy_dot": dict(rtol=1e-6, atol=3e-4)}


def _kappa_tol(route, n):
    atol = 4e-6 if route == "straight" else 8e-4 if n == 600 else 1e-5
    return dict(rtol=1e-6, atol=atol)


def _window(route, at, n):
    return tuple(t.numpy() for t in kh_window(route, at, n))


def _jax_frame(xw, yw, n, maxiter):
    sw = jf.build_smoother(n, maxiter=maxiter)
    return jf.path_parameters(*jf.smooth_path(sw, jnp.asarray(xw), jnp.asarray(yw), 0.1))


@pytest.mark.parametrize("maxiter", KH_ROUNDS)
@pytest.mark.parametrize("n", KH_WIDTHS)
@pytest.mark.parametrize("at", KH_AT)
@pytest.mark.parametrize("route", KH_ROUTES)
def test_twin_and_wrapper_match_jax(route, at, n, maxiter):
    xw, yw = _window(route, at, n)
    ref = _jax_frame(xw, yw, n, maxiter)
    sw = tf.build_smoother(n, maxiter=maxiter, device="cpu")
    x, y = torch.from_numpy(xw), torch.from_numpy(yw)
    twin = local_frame_twin(sw, x, y, 0.1)
    got = local_frame(sw, x, y, 0.1)
    chain = tf.path_parameters(*tf.smooth_path(sw, x, y, 0.1))
    for name, t, g, c, r in zip(twin._fields, twin, got, chain, ref):
        tol = _kappa_tol(route, n) if name == "kappa" else TOL[name]
        np.testing.assert_allclose(t.numpy(), np.asarray(r), **tol, err_msg=name)
        assert torch.equal(g, c), name


@pytest.mark.parametrize("where", [("x", 37), ("y", 0), ("x", 599)])
def test_twin_propagates_a_nan_waypoint_as_the_chain_does(where):
    xw, yw = _window("curved", 4000, 600)
    (xw if where[0] == "x" else yw)[where[1]] = np.nan
    sw = tf.build_smoother(600, device="cpu")
    x, y = torch.from_numpy(xw), torch.from_numpy(yw)
    twin = local_frame_twin(sw, x, y, 0.1)
    chain = local_frame(sw, x, y, 0.1)
    for name, t, c in zip(twin._fields, twin, chain):
        assert torch.equal(t.isnan(), c.isnan()), name
        assert bool(c.isnan().any()), name


def _exact_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest float32, ties to even."""
    r = np.float32(float(v))
    cands = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - v) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma32_rounds_once_at_ties_of_the_float64_sum():
    """The twin's fused multiply-add against the exact rational value
    rounded to float32: random triples, and triples whose float64 sum lands
    exactly halfway between two floats while the exact sum does not (found
    by search from this generator)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = rng.standard_normal(4000).astype(np.float32)
    # c = 1 + k ulp, a b just past half an ulp by a bit below float64's reach
    k = rng.integers(0, 2 ** 20, 4000)
    c2 = (1.0 + k * 2.0 ** -23).astype(np.float32)
    a2 = np.float32(2.0 ** -24) * (1 + rng.integers(0, 4, 4000) * np.float32(2.0 ** -23))
    b2 = (1.0 + rng.choice([-1, 1], 4000) * 2.0 ** -23 * rng.integers(1, 3, 4000)).astype(
        np.float32)
    a, b, c = (np.concatenate(p).astype(np.float32) for p in ((a, a2), (b, b2), (c, c2)))
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    ties = 0
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        s = np.float64(a[i]) * np.float64(b[i]) + np.float64(c[i])
        lo = np.float32(s)
        mid = (Fraction(float(lo)) + Fraction(float(np.nextafter(lo, np.float32(np.inf))))) / 2
        mid2 = (Fraction(float(lo)) + Fraction(float(np.nextafter(lo, np.float32(-np.inf))))) / 2
        ties += Fraction(float(s)) in (mid, mid2) and Fraction(float(s)) != exact
        assert got[i] == _exact_f32(exact), (a[i], b[i], c[i])
    assert ties > 50


@pytest.mark.parametrize("K", [70, 601])
def test_gemv_rows_chains_32_lanes_then_a_tree(K):
    """gemv_rows against cuBLAS's order written out term by term: a
    lane's block of ceil(K / 32) terms at 70 columns, its terms 32 apart at
    601; and exactly on small integers."""
    rng = np.random.default_rng(K)
    A = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    got = gemv_rows(A, x)
    T = -(-K // 32)
    for r in range(3):
        lanes = [torch.tensor(0.0) for _ in range(32)]
        for k in range(K):
            lane = k % 32 if K >= STRIDED_FROM else k // T
            lanes[lane] = fma32(A[r, k], x[k], lanes[lane])
        off = 16
        while off:
            lanes = [lanes[i] + lanes[i + off] for i in range(off)]
            off //= 2
        assert got[r] == lanes[0]
    Ai = torch.from_numpy(rng.integers(-9, 10, (40, K)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-9, 10, K).astype(np.float32))
    assert torch.equal(gemv_rows(Ai, xi), Ai @ xi)


@pytest.mark.parametrize("n", [1, 15, 16, 599, 600, 961])
def test_cub_cumsum_is_a_cumulative_sum_whose_early_outputs_ignore_later_items(n):
    """Exact on small integers (any order is); within float32 round-off of
    a float64 cumulative sum; and its first n - 1 outputs the scan of the
    first n - 1 items, which kernel (h) relies on."""
    rng = np.random.default_rng(n)
    xi = torch.from_numpy(rng.integers(0, 9, n).astype(np.float32))
    assert torch.equal(cub_cumsum(xi), torch.cumsum(xi, 0))
    x = torch.from_numpy(rng.uniform(0.3, 0.7, n).astype(np.float32))
    got = cub_cumsum(x)
    np.testing.assert_allclose(got.numpy(), np.cumsum(x.numpy().astype(np.float64)),
                               rtol=1e-5)
    if n > 1:
        assert torch.equal(cub_cumsum(x[:-1]), got[:-1])


def test_local_problem_routes_through_h_and_the_obstacle_form(monkeypatch):
    """local_problem on the CPU: one call of ops.local_frame and one of the
    obstacle form with the horizon's times, and every output the bits of
    the chains it replaces (the smoother, the path parameters, the
    obstacles' conversion and constant-velocity trajectories, the inputs
    as float32 copies of the host's float64)."""
    cfg = onroad_workload(num_reduced=3, num_obs=2, num_prime=20)
    plant = tcl.SyntheticPlant(cfg, tcl.make_route("curved"), ((20.0, 0.5), (45.0, 3.0)),
                               obstacle_speed=1.5)
    for _ in range(4):
        plant.step(0.5, 0.02)
    tot = torch.linspace(0, cfg.horizon.t_fin, cfg.horizon.num)
    sw = tf.build_smoother(cfg.frenet.num_path, device="cpu")
    calls = []

    def count(name, fn):
        def call(*args, **kw):
            calls.append((name, tuple(kw)))
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(tcl, "local_frame", count("h", ops.local_frame))
    monkeypatch.setattr(tcl, "frenet_obstacles", count("g", ops.frenet_obstacles))
    frame, x_obs, y_obs, init = tcl.local_problem(cfg, plant, sw, tot)
    assert calls == [("h", ()), ("g", ("tot_time",))]

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    x_e, y_e, v_e, psi_e, psidot_e = plant.state
    x_wp, y_wp, _ = tf.waypoint_window(plant.spline, x_e, y_e, cfg.frenet.lookahead,
                                       cfg.frenet.num_path)
    ref = tf.path_parameters(*tf.smooth_path(sw, f32(x_wp - x_e), f32(y_wp - y_e),
                                             cfg.frenet.smooth_threshold))
    obs = tcl.perceive_obstacles(cfg, plant, (x_e, y_e), psi_e).copy()
    obs[:, 0] -= x_e
    obs[:, 1] -= y_e
    conv = tf.global_to_frenet_obstacle(ref, *f32(obs[:, :5]).unbind(1))
    xo, yo, _ = constant_velocity_obstacles(*conv, tot)
    for name, g, r in zip(frame._fields, frame, ref):
        assert torch.equal(g, r), name
    assert torch.equal(x_obs, xo) and torch.equal(y_obs, yo)
    assert torch.equal(init, f32([0.0, 0.0, v_e, plant.vdot, psi_e, psidot_e]))


def test_obstacle_form_with_times_gives_the_chains_trajectories():
    """ops.frenet_obstacles with tot_time on the CPU: the five conversions
    and x_obs, y_obs of dynamics.constant_velocity_obstacles, bit for bit;
    a tot_time that is not 1-d is refused."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case
    frame, x, y = kg_case("ragged_sizes")
    rng = np.random.default_rng(2)
    m = x.shape[0]
    obs = torch.stack((x, y, torch.from_numpy(rng.normal(0, 3, m).astype(np.float32)),
                       torch.from_numpy(rng.normal(0, 1, m).astype(np.float32)),
                       torch.from_numpy(rng.uniform(0, 3, m).astype(np.float32))), dim=1)
    tot = torch.linspace(0.0, 7.5, 50)
    got = ops.frenet_obstacles(frame, obs, tot_time=tot)
    conv = tf.global_to_frenet_obstacle(frame, *obs.unbind(1))
    ref = tuple(conv) + constant_velocity_obstacles(*conv, tot)[:2]
    assert len(got) == 7
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        ops.frenet_obstacles(frame, obs, tot_time=tot[None])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    sw = tf.build_smoother(64, device="cpu")
    with pytest.raises(ValueError):
        local_frame(sw, torch.zeros(63), torch.zeros(64))
    with pytest.raises(ValueError):
        local_frame_twin(sw, torch.zeros(64), torch.zeros(65))


def test_a_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Without the CUDA toolkit the kernels' build raises, as a launch of
    (h) on the card would: nothing falls back to the chain."""
    from mpc_mmd_tpu_torch.ops import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
