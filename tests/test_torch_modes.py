"""The port's other risk modes and the dynamic workload vs the JAX package.

One outer iteration of ``cvar``, ``mmd_random`` and ``saa`` (static
workload, gaussian noise) and of the dynamic workload's ``mmd_opt`` with
Beta noise and the fused selection (``MPC_MMD_FUSED_CEM=1``), each on the
JAX package's own draws (``test_torch_noise.jax_draws`` and ``jax_beta``).
The returned controls must agree within 1e-3, the JAX package's parity
bar (tests/test_parity.py:132-145), and the risk and CEM moments at rtol
1e-3.

The solve returns the candidate of least obstacle risk, ties going to the
earlier one in projection-residual order; those residuals are float32
round-off, so a tie makes the returned candidate differ between the
packages while every value the tie does not touch agrees.  The scenarios
are chosen so the least risk is unique: the tie-free blocking scenarios of
tests/conftest.py, and for ``saa``, whose risk takes only R + 1 values, a
lone obstacle in the ego's lane at 40 m (the second one far past the
horizon), which exactly one candidate avoids best.  The JAX side of the dynamic case runs its default selection ("xla"
with elite-carry); the JAX package holds its two selections equal
(tests/test_ops.py:47-69,219-254).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import blocking_scenarios
from mpc_mmd_tpu import Solver as JSolver
from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu_torch import Solver as TSolver
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops import topk_kernel_matrices
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from test_torch_noise import jax_beta, jax_draws, to_torch_cfg
from test_torch_solver import COV, INIT, MEAN, _controls

torch.set_num_threads(1)


def _small(cfg):
    """16 candidates would be fewer than the 20 the solve keeps by risk,
    which the JAX package's mmd_random branch does not take."""
    return cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=1),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                     maxiter=3))


def _lone_obstacle(tot_time):
    t = np.asarray(tot_time)
    return (np.stack([40.0 + 0 * t, 500.0 + 0 * t]).astype(np.float32),
            np.stack([1.75 + 0 * t, 0 * t]).astype(np.float32))


def _one_iteration(cfg, monkeypatch, idx_mpc=42, lone=False, port_env=()):
    js = JSolver(cfg)
    ws = {n: np.asarray(getattr(js.ws, n)) for n in js.ws._fields}
    if lone:
        xo, yo = _lone_obstacle(js.ws.tot_time)
    else:
        xts, yts = blocking_scenarios(js.ws.tot_time, 1)
        xo, yo = np.asarray(xts[0]), np.asarray(yts[0])
    ref = js.solve(idx_mpc, jnp.asarray(INIT), jnp.asarray(MEAN),
                   jnp.asarray(COV), jnp.asarray(xo), jnp.asarray(yo), 15.0)
    for name, value in port_env:
        monkeypatch.setenv(name, value)
    ts = TSolver(to_torch_cfg(cfg), device="cpu",
                 noise=FixedNoise(jax_draws(cfg, idx_mpc), "cpu", jax_beta),
                 ws=workspace_from_numpy(ws, "cpu"))
    got = ts.solve(idx_mpc, INIT, MEAN, COV, xo, yo, 15.0)
    a_r, s_r = _controls(js.ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(js.ws, cfg, jnp.asarray(got.cx.numpy()),
                         jnp.asarray(got.cy.numpy()))
    assert np.max(np.abs(a_r - a_m)) <= 1e-3
    assert np.max(np.abs(s_r - s_m)) <= 1e-3
    for name in ("risk_obs", "risk_lane", "mean_param", "cov_param", "res"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    return got, ref


@pytest.mark.parametrize("mode,idx_mpc,lone", [
    ("cvar", 42, False), ("cvar", 7, True), ("mmd_random", 42, False),
    ("mmd_random", 7, True), ("saa", 42, True), ("saa", 7, True)])
def test_one_outer_iteration_of_each_mode_matches_jax(monkeypatch, mode,
                                                      idx_mpc, lone):
    cfg = _small(jc.fastrt_workload(num_reduced=4, num_obs=2, mode=mode))
    got, ref = _one_iteration(cfg, monkeypatch, idx_mpc, lone)
    # uniform weights, bandwidth 0.01 and no inner residual off mmd_opt
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(ref.beta))
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(ref.sigma))
    assert not got.res_beta.any()


def test_obstacle_term_projection_in_the_straight_solve_matches_jax(monkeypatch):
    """``with_obstacle_terms`` in ``Solver``: the projection reads the
    obstacles' full trajectories, as the JAX solve hands them over."""
    cfg = _small(jc.fastrt_workload(num_reduced=4, num_obs=2, mode="cvar"))
    cfg = cfg.replace(projection=dataclasses.replace(cfg.projection,
                                                     with_obstacle_terms=True))
    _one_iteration(cfg, monkeypatch)


def test_dynamic_beta_fused_iteration_matches_jax(monkeypatch):
    """Path A at a small size: Beta noise 0.2, k_steer 0.05, the fused
    selection in the port against the JAX package's default selection."""
    monkeypatch.delenv("MPC_MMD_FUSED_CEM", raising=False)
    monkeypatch.delenv("MPC_MMD_SELECTION", raising=False)
    cfg = _small(jc.dynamic_workload(num_reduced=4, num_obs=2, noise_level=0.2))
    before = topk_kernel_matrices.launches
    got, ref = _one_iteration(cfg, monkeypatch,
                              port_env=[("MPC_MMD_FUSED_CEM", "1")])
    assert topk_kernel_matrices.launches == before   # CPU: the plain twin
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.sigma.numpy(), np.asarray(ref.sigma),
                               rtol=1e-3)
    assert float(got.beta.sum()) == pytest.approx(1.0, abs=1e-3)


def test_solve_batch_equals_per_scenario_solves():
    cfg = to_torch_cfg(_small(jc.dynamic_workload(num_reduced=3, num_obs=2,
                                                  num_prime=15, mode="cvar")))
    solver = TSolver(cfg, device="cpu")
    xts, yts = blocking_scenarios(jnp.asarray(solver.ws.tot_time.numpy()), 3)
    xts, yts = np.asarray(xts), np.asarray(yts)
    seeds = [5, 6, 7]
    rb = solver.solve_batch(seeds, INIT, MEAN, COV, xts, yts, 15.0)
    assert rb.cx.shape == (3, 11) and rb.res.shape == (3, 1)
    for i, s in enumerate(seeds):
        r = solver.solve(s, INIT, MEAN, COV, xts[i], yts[i], 15.0)
        for name in r._fields:
            assert torch.equal(getattr(rb, name)[i], getattr(r, name)), name
