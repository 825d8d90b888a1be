"""PyTorch port vs JAX package: the batched inner beta-CEM and the MMD risk.

Both packages get identical (cx, cy, x_roll, y_roll) and the same inner
draws (the port through ``FixedNoise``, rebuilt from the JAX key chain).
Index-derived outputs (which rollouts form the reduced set, in which slot
order) must be equal exactly; float outputs agree at rtol 1e-4, the bound
tests/test_ops.py holds the JAX package's selection variants to.  The
"xla" selection runs with and without elite-carry, the "fused" one (the
Pallas kernel in interpret mode on the JAX side) with full recompute.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import risk as jrisk
from mpc_mmd_tpu.reduced_set import select_reduced_set_batched as j_select
from mpc_mmd_tpu_torch import risk as trisk
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.reduced_set import resolve_selection
from mpc_mmd_tpu_torch.reduced_set import select_reduced_set_batched as t_select
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)


def _cfg(maxiter):
    cfg = jc.static_workload(num_reduced=4, num_obs=2, num_prime=20)
    return cfg.replace(beta_cem=dataclasses.replace(
        cfg.beta_cem, num_samples_cem=16, maxiter=maxiter))


def _inputs(rng, C, M, nvar=11, T=20):
    return tuple(rng.normal(0, s, (C, M, n)).astype(np.float32)
                 for s, n in ((1, nvar), (1, nvar), (5, T), (1, T)))


def _rows_of(red, roll):
    """Index in ``roll`` (C, M, T) of every row of ``red`` (C, k, T)."""
    eq = np.all(red[:, :, None, :] == roll[:, None, :, :], axis=-1)
    assert np.all(eq.sum(-1) == 1)
    return eq.argmax(-1)


@pytest.mark.parametrize("maxiter", [1, 3])
def test_select_reduced_set_batched_matches_jax(rng, maxiter):
    cfg = _cfg(maxiter)
    bc, M = cfg.beta_cem, cfg.risk.num_mother
    cx, cy, xr, yr = _inputs(rng, 3, M)
    ref = j_select(cfg, *map(jnp.asarray, (cx, cy, xr, yr)), selection="xla")
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    got = t_select(to_torch_cfg(cfg), *map(torch.from_numpy, (cx, cy, xr, yr)),
                   draws)

    np.testing.assert_array_equal(_rows_of(got.x_red.numpy(), xr),
                                  _rows_of(np.asarray(ref.x_red), xr))
    np.testing.assert_array_equal(got.x_red.numpy(), np.asarray(ref.x_red))
    np.testing.assert_array_equal(got.y_red.numpy(), np.asarray(ref.y_red))
    assert got.res.shape == (3, maxiter)
    for name in ("beta", "sigma", "res"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.beta.sum(-1).numpy(), 1.0, atol=1e-4)


def _both(cfg, inputs, **jkw):
    bc, M = cfg.beta_cem, cfg.risk.num_mother
    ref = j_select(cfg, *map(jnp.asarray, inputs), **jkw)
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    got = t_select(to_torch_cfg(cfg), *map(torch.from_numpy, inputs), draws,
                   selection=jkw.get("selection"))
    return got, ref


def _assert_same(got, ref, C, maxiter):
    np.testing.assert_array_equal(got.x_red.numpy(), np.asarray(ref.x_red))
    np.testing.assert_array_equal(got.y_red.numpy(), np.asarray(ref.y_red))
    assert got.res.shape == (C, maxiter)
    for name in ("beta", "sigma", "res"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.beta.sum(-1).numpy(), 1.0, atol=1e-4)


def _cfg3(maxiter):
    cfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=15)
    return cfg.replace(beta_cem=dataclasses.replace(
        cfg.beta_cem, num_samples_cem=40, maxiter=maxiter))


@pytest.mark.parametrize("maxiter", [1, 2, 4])
def test_fused_selection_matches_jax(rng, monkeypatch, maxiter):
    """K3's twin, the weight QP and the full-recompute loop against the
    JAX package's fused selection (Pallas kernel in interpret mode)."""
    monkeypatch.delenv("MPC_MMD_SELECTION", raising=False)
    cfg = _cfg3(maxiter)
    inputs = _inputs(rng, 3, cfg.risk.num_mother, T=15)
    got, ref = _both(cfg, inputs, selection="fused", interpret=True)
    _assert_same(got, ref, 3, maxiter)
    # MPC_MMD_FUSED_CEM=1 selects it when no selection is given
    monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    bc = cfg.beta_cem
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite, bc.maxiter)
    again = t_select(to_torch_cfg(cfg), *map(torch.from_numpy, inputs), draws)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("maxiter", [1, 2, 4])
def test_full_recompute_xla_selection_matches_jax(rng, monkeypatch, maxiter):
    """MPC_MMD_ELITE_CARRY=0: every row recomputed in every iteration."""
    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", "0")
    cfg = _cfg3(maxiter)
    inputs = _inputs(rng, 3, cfg.risk.num_mother, T=15)
    got, ref = _both(cfg, inputs, selection="xla")
    _assert_same(got, ref, 3, maxiter)


def test_selection_resolves_as_in_jax(monkeypatch):
    cfg = to_torch_cfg(_cfg3(1))
    for var in ("MPC_MMD_SELECTION", "MPC_MMD_FUSED_CEM"):
        monkeypatch.delenv(var, raising=False)
    assert resolve_selection(cfg) == "xla"
    monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    assert resolve_selection(cfg) == "fused"
    assert resolve_selection(cfg.replace(solve_strategy="exact")) == "xla"
    monkeypatch.setenv("MPC_MMD_SELECTION", "xla")
    assert resolve_selection(cfg) == "xla"
    assert resolve_selection(cfg, "fused") == "fused"
    for sel in ("xt", "g"):
        monkeypatch.setenv("MPC_MMD_SELECTION", sel)
        with pytest.raises(NotImplementedError):
            resolve_selection(cfg)
    with pytest.raises(ValueError):
        resolve_selection(cfg, "bogus")


def test_select_reduced_set_survives_nan_samples(rng):
    """A poisoned rollout (NaN coefficients) gives NaN kernel rows; those
    samples cost +inf and never win, so the result stays finite and
    matches the JAX package's NaN rules."""
    cfg = _cfg(3)
    bc, M = cfg.beta_cem, cfg.risk.num_mother
    cx, cy, xr, yr = _inputs(rng, 2, M)
    cx[1, 5] = np.nan
    ref = j_select(cfg, *map(jnp.asarray, (cx, cy, xr, yr)), selection="xla")
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    got = t_select(to_torch_cfg(cfg), *map(torch.from_numpy, (cx, cy, xr, yr)),
                   draws)
    np.testing.assert_array_equal(got.x_red.numpy(), np.asarray(ref.x_red))
    np.testing.assert_allclose(got.res.numpy(), np.asarray(ref.res),
                               rtol=1e-4, atol=1e-6)
    assert np.all(np.isfinite(got.beta.numpy()))


def test_mmd_risks_match_jax(rng):
    cfg = jc.static_workload(num_reduced=4, num_obs=2, num_prime=20)
    C, k, T = 6, 4, 20
    beta = rng.dirichlet(np.ones(k), C).astype(np.float32)
    sigma = rng.uniform(0.01, 10, C).astype(np.float32)
    xr = rng.normal(10, 4, (C, k, T)).astype(np.float32)
    yr = rng.normal(0, 2.5, (C, k, T)).astype(np.float32)
    xo = rng.normal(10, 2, (2, T)).astype(np.float32)
    yo = rng.normal(0, 1, (2, T)).astype(np.float32)
    j_obs = jax.vmap(lambda b, s, x, y: jrisk.mmd_obs(
        cfg, b, s, x, y, jnp.asarray(xo), jnp.asarray(yo)))(
        *map(jnp.asarray, (beta, sigma, xr, yr)))
    j_lane = jax.vmap(lambda b, s, y: jrisk.mmd_lane(cfg, b, s, y))(
        *map(jnp.asarray, (beta, sigma, yr)))
    tcfg = to_torch_cfg(cfg)
    t_obs = trisk.mmd_obs(tcfg, *map(torch.from_numpy, (beta, sigma, xr, yr, xo, yo)))
    t_lane = trisk.mmd_lane(tcfg, *map(torch.from_numpy, (beta, sigma, yr)))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t_lane.numpy(), np.asarray(j_lane), rtol=1e-5, atol=1e-3)
    # a scalar bandwidth broadcasts like the JAX function's
    j1 = jrisk.mmd_lane(cfg, jnp.asarray(beta[0]), 2.0, jnp.asarray(yr[0]))
    t1 = trisk.mmd_lane(tcfg, torch.from_numpy(beta[0]), 2.0, torch.from_numpy(yr[0]))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", ["gaussian", "matern52"])
@pytest.mark.parametrize("elite_carry", ["1", "0"])
def test_other_kernel_selection_matches_jax(rng, monkeypatch, kind, elite_carry):
    """The "xla" selection under the gaussian and matern52 kernels: rows of
    D and of the squared L2 matrix D2 gathered side by side, with
    elite-carry and with full recompute.  Asked for "fused", both packages
    run "xla" (K3 hard-codes the Laplace exp)."""
    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", elite_carry)
    cfg = _cfg3(3)
    cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kind))
    inputs = _inputs(rng, 3, cfg.risk.num_mother, T=15)
    got, ref = _both(cfg, inputs, selection="xla")
    _assert_same(got, ref, 3, 3)
    assert resolve_selection(to_torch_cfg(cfg), "fused") == "xla"
    fused, _ = _both(cfg, inputs, selection="fused", interpret=True)
    for a, b in zip(fused, got):
        assert torch.equal(a, b)
