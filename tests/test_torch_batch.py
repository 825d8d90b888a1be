"""Scenario chunks: ``Solver.solve_batch`` runs ``scenario_chunk`` scenarios
through one outer CEM loop over a leading scenario axis.

A chunk must equal its scenarios solved one at a time on the same draws:
``TorchNoise`` re-seeds every family per scenario, so a scenario meets the
same draws in a chunk and alone.  Every field of the result is held within
1e-5 of its scale (on the CPU they come out bit-equal at these sizes).
Against the JAX package, ``Solver(cfg, scenario_chunk=2).solve_batch`` of
both packages on each seed's JAX draws (``test_torch_noise.JaxKeyChain``):
res, risk_obs and res_beta within rtol 1e-3 + atol 1e-3, the bar of
``test_torch_solver.py::test_three_outer_iterations_match_jax``.  The
scenarios are the tie-free blocking ones of tests/conftest.py.
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
from mpc_mmd_tpu_torch.noise import (FixedNoise, TorchNoise, chunk_cem_z,
                                     chunk_rollout_beta, chunk_rollout_eps)
from mpc_mmd_tpu_torch.qp import workspace_from_numpy
from test_torch_noise import JaxKeyChain, jax_draws, to_torch_cfg
from test_torch_solver import COV, INIT, MEAN

torch.set_num_threads(1)

FIELDS = ("cx", "cy", "risk_obs", "res", "res_2", "mean_param", "cov_param")


def _cfg(mode="mmd_opt", noise="gaussian", obstacle_terms=False):
    make = jc.dynamic_workload if noise == "beta" else jc.fastrt_workload
    cfg = make(num_reduced=3, num_obs=2, num_prime=15, mode=mode, noise=noise)
    return cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=2),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16, maxiter=3),
        projection=dataclasses.replace(cfg.projection,
                                       with_obstacle_terms=obstacle_terms))


def _scenarios(solver, n):
    xts, yts = blocking_scenarios(jnp.asarray(solver.ws.tot_time.numpy()), n)
    return np.asarray(xts), np.asarray(yts)


def _assert_chunk_equals_singles(solver, seeds, xts, yts):
    batch = solver.solve_batch(seeds, INIT, MEAN, COV, xts, yts, 15.0)
    assert batch.cx.shape == (len(seeds), solver.cfg.horizon.nvar)
    for i, seed in enumerate(seeds):
        one = solver.solve(seed, INIT, MEAN, COV, xts[i], yts[i], 15.0)
        for name in FIELDS + ("beta", "sigma", "res_beta", "risk_lane"):
            ref = getattr(one, name)
            scale = max(1.0, float(ref.abs().max()))
            np.testing.assert_allclose(getattr(batch, name)[i].numpy(), ref.numpy(),
                                       rtol=0, atol=1e-5 * scale, err_msg=name)
    return batch


@pytest.mark.parametrize("mode,noise,fused,obstacle_terms", [
    ("mmd_opt", "gaussian", False, False), ("mmd_opt", "gaussian", True, False),
    ("cvar", "gaussian", False, False), ("mmd_opt", "beta", False, False),
    ("cvar", "beta", False, True)])
def test_chunk_equals_its_scenarios_one_at_a_time(monkeypatch, mode, noise, fused,
                                                  obstacle_terms):
    """A chunk of 3 in mmd_opt ("xla" with elite-carry, and "fused"), cvar,
    Beta noise, and the obstacle-term projection, whose obstacles differ
    per scenario of the chunk."""
    monkeypatch.delenv("MPC_MMD_SELECTION", raising=False)
    if fused:
        monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    else:
        monkeypatch.delenv("MPC_MMD_FUSED_CEM", raising=False)
    cfg = to_torch_cfg(_cfg(mode, noise, obstacle_terms))
    solver = TSolver(cfg, device="cpu", scenario_chunk=3)
    xts, yts = _scenarios(solver, 3)
    batch = _assert_chunk_equals_singles(solver, [11, 5, 7], xts, yts)
    # the scenarios differ, so a chunk is not one scenario repeated
    assert not torch.equal(batch.cx[0], batch.cx[1])


def test_short_last_chunk(monkeypatch):
    """Five scenarios at chunk 2: chunks of 2, 2 and 1."""
    monkeypatch.setenv("MPC_MMD_SCENARIO_CHUNK", "2")
    solver = TSolver(to_torch_cfg(_cfg("cvar", "beta")), device="cpu")
    assert solver.scenario_chunk == 2
    xts, yts = _scenarios(solver, 5)
    batch = _assert_chunk_equals_singles(solver, [3, 1, 4, 1, 5], xts, yts)
    assert batch.res.shape == (5, 2)


def test_chunk_draws_stack_each_scenarios_own():
    """The chunk's per-iteration draws are each scenario's own, stacked on
    a leading axis; FixedNoise gives every scenario its one set."""
    noise = TorchNoise(torch.Generator(), "cpu")
    seeds = [4, 9, 4]
    eps = chunk_rollout_eps(noise, seeds, 1, 3, 6)
    z = chunk_cem_z(noise, seeds, 1, 5, 8)
    alpha = torch.rand(2, 3, 2, 6) + 1e-8
    beta = chunk_rollout_beta(noise, seeds, 1, 3, alpha, 2.5 * alpha)
    assert [e.shape for e in eps] == [(3, 3, 6)] * 3 and z.shape == (3, 5, 8)
    assert beta.shape == (2, 3, 2, 3, 6)
    for i, s in enumerate(seeds):
        for got, ref in zip(eps, noise.rollout_eps(s, 1, 3, 6)):
            assert torch.equal(got[i], ref)
        assert torch.equal(z[i], noise.cem_z(s, 1, 5, 8))
        assert torch.equal(beta[:, i], noise.rollout_beta(s, 1, 3, alpha[:, i],
                                                           2.5 * alpha[:, i]))
    assert not torch.equal(z[0], z[1]) and torch.equal(z[0], z[2])
    fixed = FixedNoise(jax_draws(_cfg(), 0), "cpu")
    z = chunk_cem_z(fixed, [1, 2], 0, 19, 8)
    assert torch.equal(z[0], z[1])


def test_solve_batch_at_chunk_2_matches_jax():
    """Four seeds, two chunks of 2, three outer iterations, mmd_opt, on
    the JAX draws of each seed."""
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2)
    cfg = cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=3),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16, maxiter=3))
    js = JSolver(cfg, scenario_chunk=2)
    seeds = [42, 7, 13, 5]
    xts, yts = blocking_scenarios(js.ws.tot_time, 4)
    ref = js.solve_batch(jnp.asarray(seeds, jnp.int32), jnp.asarray(INIT),
                         jnp.asarray(MEAN), jnp.asarray(COV), xts, yts, 15.0)
    ws = workspace_from_numpy({n: np.asarray(getattr(js.ws, n))
                               for n in js.ws._fields}, "cpu")
    ts = TSolver(to_torch_cfg(cfg), device="cpu", noise=JaxKeyChain(cfg), ws=ws,
                 scenario_chunk=2)
    got = ts.solve_batch(seeds, INIT, MEAN, COV, np.asarray(xts), np.asarray(yts),
                         15.0)
    assert got.res.shape == (4, 3) and got.res_beta.shape == (4, 3)
    for name in ("res", "risk_obs", "res_beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    for name in ("cx", "cy", "beta", "mean_param", "cov_param"):
        assert np.all(np.isfinite(getattr(got, name).numpy())), name
