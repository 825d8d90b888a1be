"""The PyTorch port's noise injection, and the JAX key chain it replays.

:func:`jax_draws` rebuilds, with ``jax.random``, every standard-normal draw
the JAX package makes in one ``mmd_opt`` solve, in the shapes of
``mpc_mmd_tpu_torch.noise``.  Fed through ``FixedNoise``, it lets the port
run on the JAX package's exact random numbers; the other ``test_torch_*``
files import it from here.  The key chain follows sampling.py:34-39,
solver.py:186,202,299, dynamics.py:91-120 and reduced_set.py:432-466.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_mmd_tpu.config as jcfg_mod
import mpc_mmd_tpu_torch.config as tcfg_mod
from mpc_mmd_tpu import sampling as jsampling
from mpc_mmd_tpu_torch import sampling as tsampling
from mpc_mmd_tpu_torch.noise import FixedNoise, InnerDraws, TorchNoise

torch.set_num_threads(1)


def to_torch_cfg(cfg):
    """The port's ProblemConfig with every field of a JAX ProblemConfig."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tcfg_mod, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tcfg_mod.ProblemConfig(**kw)


def jax_draws(cfg, idx_mpc):
    """Every standard normal of one JAX ``mmd_opt`` solve, as numpy arrays.

    ``jax.random.multivariate_normal(key, mean, cov, shape)`` is
    ``mean + chol(cov) z`` with ``z = jax.random.normal(key, shape + (n,))``,
    so each draw is taken as that ``z``.
    """
    split, normal = jax.random.split, jax.random.normal
    c, bc = cfg.cem, cfg.beta_cem
    R, T, M = cfg.risk.num_reduced, cfg.horizon.num_prime, cfg.risk.num_mother
    S, n_el = bc.num_samples_cem, bc.num_ellite

    out = {"initial_z": normal(split(jax.random.PRNGKey(0))[0],
                               (c.num_batch, c.num_params))}

    key0, _ = split(jax.random.PRNGKey(0))
    out["samples0"] = normal(split(key0)[0], (S, M + 1))
    kc, ku_list, kz_list = key0, [], []
    for _ in range(bc.maxiter):
        kc, _ = split(kc)
        ku, kz = split(split(kc)[0])
        ku_list.append(ku)
        kz_list.append(kz)
    out["u"] = jax.vmap(lambda k: normal(k, (S - n_el, n_el)))(jnp.stack(ku_list))
    out["z"] = jax.vmap(lambda k: normal(k, (S - n_el, M + 1)))(jnp.stack(kz_list))

    per_it = {n: [] for n in ("eps_acc", "eps_steer", "eps_const", "cem_z")}
    for it in range(c.maxiter_cem):
        k_roll, _ = split(jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))
        k_steer, _ = split(k_roll)
        k_const, _ = split(k_steer)
        per_it["eps_acc"].append(normal(k_roll, (R, T)))
        per_it["eps_steer"].append(normal(k_steer, (R, T)))
        per_it["eps_const"].append(normal(k_const, (R, T)))
        # the solver's cem key is split(k_roll)[0], the same key as eps_steer
        per_it["cem_z"].append(normal(k_steer, (c.num_batch - c.ellite_num,
                                                c.num_params)))
    out.update({n: jnp.stack(v) for n, v in per_it.items()})
    return {n: np.array(v) for n, v in out.items()}


def _cfg():
    cfg = jcfg_mod.fastrt_workload(num_reduced=3, num_obs=2, num_prime=12)
    return cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=12, maxiter_cem=2),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12,
                                     maxiter=2))


def test_fixed_noise_replays_shapes_and_values():
    cfg = _cfg()
    d = jax_draws(cfg, 5)
    n = FixedNoise(d, "cpu")
    bc, c = cfg.beta_cem, cfg.cem
    inner = n.inner_cem(bc.num_samples_cem, cfg.risk.num_mother,
                        bc.num_ellite, bc.maxiter)
    np.testing.assert_array_equal(inner.u.numpy(), d["u"])
    np.testing.assert_array_equal(n.initial_z(c.num_batch, 8).numpy(),
                                  d["initial_z"])
    ea, es, ec = n.rollout_eps(5, 1, 3, 12)
    np.testing.assert_array_equal(es.numpy(), d["eps_steer"][1])
    assert n.cem_z(5, 1, c.num_batch - c.ellite_num, 8).shape == (7, 8)
    with pytest.raises(ValueError):
        n.initial_z(c.num_batch + 1, 8)


def test_torch_noise_is_a_function_of_the_solve():
    """Re-seeded per family: the same (idx_mpc, iteration) gives the same
    draws in any order, and different iterations differ."""
    a = TorchNoise(torch.Generator(), "cpu")
    b = TorchNoise(torch.Generator(), "cpu")
    e1 = a.rollout_eps(3, 1, 4, 10)
    a.cem_z(3, 0, 7, 8)
    e2 = a.rollout_eps(3, 1, 4, 10)
    for x, y in zip(e1, e2):
        assert torch.equal(x, y)
    assert not torch.equal(e1[0], a.rollout_eps(3, 2, 4, 10)[0])
    assert not torch.equal(e1[0], e1[1])
    i1, i2 = a.inner_cem(12, 9, 3, 2), b.inner_cem(12, 9, 3, 2)
    assert isinstance(i1, InnerDraws)
    assert all(torch.equal(x, y) for x, y in zip(i1, i2))
    assert i1.z.shape == (2, 9, 10)
    with pytest.raises(ValueError):
        TorchNoise(torch.Generator(), "meta")


def test_initial_params_matches_jax_multivariate_normal():
    cfg = _cfg()
    mean = np.asarray([15.0] * 4 + [0.0] * 4, np.float32)
    cov = np.diag([20.0] * 4 + [100.0] * 4).astype(np.float32)
    ref = jsampling.initial_params(cfg, jnp.asarray(mean), jnp.asarray(cov))
    got = tsampling.initial_params(to_torch_cfg(cfg), torch.from_numpy(mean),
                                   torch.from_numpy(cov),
                                   torch.from_numpy(jax_draws(cfg, 0)["initial_z"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_cem_update_matches_jax_with_a_full_covariance(rng):
    cfg = _cfg()
    idx_mpc, it = 4, 1
    pe = rng.normal(10, 3, (cfg.cem.ellite_num, 8)).astype(np.float32)
    ce = np.sort(rng.normal(5, 1, cfg.cem.ellite_num)).astype(np.float32)
    mean = rng.normal(0, 1, 8).astype(np.float32)
    A = rng.normal(0, 1, (8, 8))
    cov = (A @ A.T + np.eye(8)).astype(np.float32)
    key = jax.random.split(jax.random.split(
        jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))[0])[0]
    ref = jsampling.cem_update(cfg, key, jnp.asarray(pe), jnp.asarray(ce),
                               jnp.asarray(mean), jnp.asarray(cov))
    z = torch.from_numpy(jax_draws(cfg, idx_mpc)["cem_z"][it])
    got = tsampling.cem_update(to_torch_cfg(cfg), z, torch.from_numpy(pe),
                               torch.from_numpy(ce), torch.from_numpy(mean),
                               torch.from_numpy(cov))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
