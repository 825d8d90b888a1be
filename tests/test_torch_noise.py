"""The PyTorch port's noise injection, and the JAX key chain it replays.

:func:`jax_draws` rebuilds, with ``jax.random``, every standard-normal draw
the JAX package makes in one solve, in the shapes of
``mpc_mmd_tpu_torch.noise``, and :func:`jax_beta` its Beta draws for the
parameters the port passes.  Fed through ``FixedNoise``, they let the port
run on the JAX package's exact random numbers; the other ``test_torch_*``
files import them from here.  The key chain follows sampling.py:34-39,
solver.py:186,202,299, dynamics.py:91-120 and reduced_set.py:432-466.

The port's own Beta sampler is held by distribution: at the parameters of
the dynamic workload, Beta(2 u, 5 u) for u from 1e-8 up, mean and variance
within 5 Monte-Carlo standard errors of the closed form.
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
from mpc_mmd_tpu_torch.noise import (FixedNoise, InnerDraws, TorchNoise,
                                     sample_beta)

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
    # the exact strategy's multivariate normal draws straight from the update
    # key, split(carried key)[0] (reduced_set.py:289-291,315-317)
    kc, upd = key0, []
    for _ in range(bc.maxiter):
        kc, _ = split(kc)
        upd.append(split(kc)[0])
    out["z_exact"] = jax.vmap(lambda k: normal(k, (S - n_el, M + 1)))(jnp.stack(upd))

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


def jax_beta(idx_mpc, it, R, alpha, beta):
    """The JAX package's Beta draws (2, C, R, T) of outer iteration ``it``
    for parameters (2, C, T): acc from ``k_roll``, steer from
    ``split(k_roll)[0]``, every candidate from the same key
    (dynamics.py:110-114, solver.py:115-116,186,202)."""
    k_roll, _ = jax.random.split(jax.random.PRNGKey(3 * idx_mpc + 5 * it + 7))
    k_steer, _ = jax.random.split(k_roll)
    T = alpha.shape[-1]
    return np.stack([np.asarray(jax.vmap(
        lambda a, b: jax.random.beta(key, a, b, (R, T)))(
            jnp.asarray(alpha[ch]), jnp.asarray(beta[ch])))
        for ch, key in enumerate((k_roll, k_steer))])


class JaxKeyChain:
    """The JAX key chain's draws of every solve of a sweep or a chunk: the
    initial batch and inner-CEM draws every solve shares, and each solve's
    own per-iteration draws (Beta ones too), keyed by its seed
    (``idx_mpc``)."""

    def __init__(self, cfg):
        self.cfg, self.by_seed = cfg, {}

    def _of(self, idx_mpc):
        if idx_mpc not in self.by_seed:
            self.by_seed[idx_mpc] = FixedNoise(jax_draws(self.cfg, idx_mpc), "cpu",
                                               jax_beta)
        return self.by_seed[idx_mpc]

    def initial_z(self, *a):
        return self._of(0).initial_z(*a)

    def inner_cem(self, *a):
        return self._of(0).inner_cem(*a)

    def inner_exact(self, *a):
        return self._of(0).inner_exact(*a)

    def rollout_eps(self, idx_mpc, *a):
        return self._of(idx_mpc).rollout_eps(idx_mpc, *a)

    def rollout_beta(self, idx_mpc, *a):
        return self._of(idx_mpc).rollout_beta(idx_mpc, *a)

    def cem_z(self, idx_mpc, *a):
        return self._of(idx_mpc).cem_z(idx_mpc, *a)


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


@pytest.mark.parametrize("alpha", [2e-8, 2e-3, 0.2, 2.0, 20.0])
def test_beta_sampler_by_distribution(alpha):
    """Beta(alpha, 2.5 alpha), the ratio of the presets' beta_a / beta_b:
    mean 2/7 and variance (10/49) / (3.5 alpha + 1) within 5 Monte-Carlo
    standard errors; at alpha = 2e-8, the every-solve case (steer(0) = 0),
    a Bernoulli(2/7) on {0, 1}."""
    n = 200_000
    a = torch.full((n,), alpha, dtype=torch.float32)
    x = sample_beta(a, 2.5 * a, torch.Generator().manual_seed(7)).double()
    assert bool(((x >= 0) & (x <= 1)).all())
    mean, var = 2 / 7, (2 / 7) * (5 / 7) / (3.5 * alpha + 1)
    assert abs(float(x.mean()) - mean) < 5 * np.sqrt(var / n)
    d2 = (x - mean) ** 2
    assert abs(float(d2.mean()) - var) < 5 * float(d2.std()) / np.sqrt(n)
    if alpha == 2e-8:
        p = float((x > 0.5).double().mean())
        assert abs(p - 2 / 7) < 5 * np.sqrt(mean * (1 - mean) / n)
        assert float(((x == 0) | (x == 1)).double().mean()) > 0.999


def test_rollout_beta_draws():
    """TorchNoise draws (2, C, R, T) as a function of the solve; FixedNoise
    replays arrays or asks its function, and checks the shape."""
    noise = TorchNoise(torch.Generator(), "cpu")
    alpha = torch.rand(2, 5, 7) + 1e-8
    d1 = noise.rollout_beta(3, 1, 4, alpha, 2.5 * alpha)
    assert d1.shape == (2, 5, 4, 7)
    assert torch.equal(d1, noise.rollout_beta(3, 1, 4, alpha, 2.5 * alpha))
    assert not torch.equal(d1, noise.rollout_beta(3, 2, 4, alpha, 2.5 * alpha))
    replay = FixedNoise({"beta": d1[None].numpy()}, "cpu")
    assert torch.equal(replay.rollout_beta(0, 0, 4, alpha, alpha), d1)
    with pytest.raises(ValueError):
        replay.rollout_beta(0, 0, 3, alpha, alpha)
    asked = FixedNoise({}, "cpu", jax_beta)
    got = asked.rollout_beta(3, 1, 4, alpha, 2.5 * alpha)
    np.testing.assert_array_equal(
        got.numpy(), jax_beta(3, 1, 4, alpha.numpy(), 2.5 * alpha.numpy()))
    with pytest.raises(ValueError):
        FixedNoise({}, "cpu").rollout_beta(0, 0, 4, alpha, alpha)


def test_recorded_draws_replay_a_solve():
    """record_solve_draws: a solve that records its Beta draws and a second
    solve that replays every draw give the same result (on the card, the
    second runs on the other device: tests/test_torch_gpu.py)."""
    from mpc_mmd_tpu_torch import Solver
    from mpc_mmd_tpu_torch.noise import record_solve_draws
    cfg = to_torch_cfg(jcfg_mod.dynamic_workload(num_reduced=3, num_obs=2,
                                                 num_prime=12, noise_level=0.2))
    cfg = cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=12, maxiter_cem=2),
        beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12, maxiter=2))
    arrays, record = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg, 3)
    t = np.linspace(0.0, 15.0, 100)
    args = ([0.0, -1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
            np.diag([20.0] * 4 + [100.0] * 4), np.stack([8 + 0 * t, 13 + 0 * t]),
            np.stack([-1.75 + 0 * t, -1.5 + 0 * t]), 15.0)
    first = Solver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu", record)).solve(3, *args)
    assert arrays["beta"].shape == (2, 2, 12, 3, 12)
    again = Solver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu")).solve(3, *args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
