"""The port's copy of ``jax.random`` (``mpc_mmd_tpu_torch/prng.py``), the
plain twins of its CUDA kernels (``ops/prng.py``) and ``noise.JaxNoise``,
against ``jax.random`` run here; then the port's solves, a Frenet step, the
validator and a sweep on their default noise against the JAX package's,
with no injected draws.

Tolerances, with the largest gaps seen here (jax 0.9.0 on the CPU, the
sizes below):

* keys, splits, bits, uniforms, permutations and choices: exact;
* normals: within 4 ulp (3 seen), the multivariate normal of an identity
  covariance too.  XLA's float32 ``log1p`` and torch's differ by an ulp now
  and then, and the erfinv polynomial's slope near +-1 widens that;
* multivariate normals of another covariance: rtol 1e-5 + atol 1e-6 (the
  product's summation order);
* log-gamma and Beta draws: rtol 1e-5 + atol 1e-6 (log-gamma values near
  0 are differences of logs, 1.8e-7 apart at most; Beta 4.8e-7).  A
  round-off in ``log`` can flip a Marsaglia-Tsang accept test and give an
  element another draw altogether: at the parameters below no element
  flips (the tests print the count).

``mpc_mmd_tpu_torch/data/prng_reference.npz`` holds JAX's draws for fixed
keys and the JAX package's full-width fastrt solve, for ``chip_smoke.py``
phase 15 (the card has no JAX).  To write it again (JAX needed; the solve
takes about 20 s and 0.7 GB here)::

    python -c "import sys, numpy as np; sys.path.insert(0, 'tests'); \\
      from test_torch_prng import jax_prng_reference; \\
      np.savez_compressed('mpc_mmd_tpu_torch/data/prng_reference.npz', \\
                          **jax_prng_reference())"
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_mmd_tpu.cli.sweep as j_sweep
from conftest import blocking_scenarios
from mpc_mmd_tpu import Solver as JSolver
from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import sampling as jsampling
from mpc_mmd_tpu.qp import build_workspace as j_build_workspace
from mpc_mmd_tpu.validate import make_validator_core as j_core
from mpc_mmd_tpu_torch import FrenetSolver as TFrenetSolver
from mpc_mmd_tpu_torch import Solver as TSolver
from mpc_mmd_tpu_torch import ops, prng
from mpc_mmd_tpu_torch.cli import sweep
from mpc_mmd_tpu_torch.config import static_workload
from mpc_mmd_tpu_torch.noise import (JaxNoise, init_state_count,
                                     record_solve_draws)
from mpc_mmd_tpu_torch.qp import build_workspace, workspace_from_numpy
from mpc_mmd_tpu_torch.validate import make_validator_core
from test_torch_frenet import COV0, IDX, MEAN0, _scenario, frenet_cfg, jax_solver
from test_torch_noise import jax_beta, jax_draws, to_torch_cfg
from test_torch_solver import (COV, INIT, MEAN, _assert_one_iteration, _cfg,
                               _controls, _record_cell_jax)
from test_torch_validate import INIT as VINIT
from test_torch_validate import _obstacles, _solves, jax_mc_draws

torch.set_num_threads(1)

REFERENCE = (Path(__file__).resolve().parents[1] / "mpc_mmd_tpu_torch" / "data"
             / "prng_reference.npz")
ULP = 4


def _key(seed):
    return prng.key(seed)


def _np(keys):
    return torch.as_tensor(np.asarray(keys).astype(np.int64))


def _ulps(a, b):
    """Elementwise distance in float32 ulps (both finite, same sign near)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _solve_parameters(rng, n, scale):
    """Beta parameters as the solve sets them (dynamics.py:108-114):
    a |u| and b |u| with |u| floored at 1e-8, u = 0 included."""
    u = np.abs(rng.normal(size=n)).astype(np.float32) * np.float32(scale)
    u[:3] = 0.0
    g = u + np.float32(1e-8)
    return np.float32(2.0) * g, np.float32(5.0) * g


def test_jax_config_is_what_the_port_assumes():
    """prng.py follows partitionable threefry (the default since jax 0.5)
    and 32-bit integers; read, not changed."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_enable_x64 is False


@pytest.mark.parametrize("seed", [0, 5, 123456789, 2 ** 31 - 1, 2 ** 32 + 3, -1])
def test_keys_and_splits_equal_jax(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(_key(seed).numpy(), np.asarray(k).astype(np.int64))
    for num in (1, 2, 3, 7):
        assert np.array_equal(prng.split(_key(seed), num).numpy(),
                              np.asarray(jax.random.split(k, num)).astype(np.int64))
    # a batch of keys splits as jax.vmap(split) does, and split_int as split
    ks = jax.random.split(k, 5)
    assert np.array_equal(prng.split(_np(ks), 3).numpy(),
                          np.asarray(jax.vmap(lambda kk: jax.random.split(kk, 3))(ks)))
    pair = tuple(int(w) for w in np.asarray(k))
    assert np.array_equal(np.asarray(prng.split_int(pair, 3)),
                          np.asarray(jax.random.split(k, 3)).astype(np.int64))


def test_hash_with_high_counter_words_equals_jax():
    """Element i of a draw hashes the counter (i >> 32, i & 0xffffffff):
    the hash past 2^32 (high word set) equals JAX's threefry primitive, and
    the counters of a shape are JAX's ``iota_2x32_shape``."""
    from jax._src import prng as jprng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64)
    hi = rng.integers(1, 2 ** 32, size=257, dtype=np.uint64)
    lo = rng.integers(0, 2 ** 32, size=257, dtype=np.uint64)
    ref = jprng.threefry2x32_p.bind(*(jnp.asarray(x.astype(np.uint32)) for x in
                                      (np.full(257, k[0]), np.full(257, k[1]), hi, lo)))
    got = prng.threefry2x32(int(k[0]), int(k[1]), torch.as_tensor(hi.astype(np.int64)),
                            torch.as_tensor(lo.astype(np.int64)))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))
    hi_j, lo_j = jprng.iota_2x32_shape((3, 5, 7))
    i = np.arange(105, dtype=np.int64).reshape(3, 5, 7)
    assert np.array_equal(np.asarray(hi_j), i >> 32)
    assert np.array_equal(np.asarray(lo_j), i & 0xFFFFFFFF)


@pytest.mark.parametrize("shape", [(), (1,), (5, 7, 3), (2 ** 16 + 37,)])
def test_random_bits_equal_jax(shape):
    """At odd shapes and past 2^16 along one axis; a batch of keys as
    ``jax.vmap``."""
    ref = jax.random.bits(jax.random.PRNGKey(3), shape, jnp.uint32)
    assert np.array_equal(prng.random_bits(_key(3), shape).numpy(),
                          np.asarray(ref).astype(np.int64))
    ks = jax.random.split(jax.random.PRNGKey(4), 3)
    ref = jax.vmap(lambda kk: jax.random.bits(kk, shape, jnp.uint32))(ks)
    assert np.array_equal(prng.random_bits(_np(ks), shape).numpy(),
                          np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0), (1e-3, 1.0)])
def test_uniforms_equal_jax(lo, hi):
    ref = jax.random.uniform(jax.random.PRNGKey(4), (1001,), minval=lo, maxval=hi)
    assert np.array_equal(prng.uniform(_key(4), (1001,), lo, hi).numpy(),
                          np.asarray(ref))


def test_normals_within_four_ulp():
    got = prng.normal(_key(4), (200_000,)).numpy()
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (200_000,)))
    gap = _ulps(got, ref)
    print(f"normals: largest gap {gap.max()} ulp, {np.count_nonzero(gap)} of "
          f"{gap.size} differ")
    assert gap.max() <= ULP
    ks = jax.random.split(jax.random.PRNGKey(9), 4)
    ref = jax.vmap(lambda kk: jax.random.normal(kk, (3, 5)))(ks)
    assert _ulps(prng.normal(_np(ks), (3, 5)).numpy(), ref).max() <= ULP


def test_multivariate_normals():
    """Identity covariance (every multivariate normal of the JAX solve):
    within 4 ulp; an SPD covariance within rtol 1e-5 + atol 1e-6."""
    k = jax.random.PRNGKey(11)
    ref = jax.random.multivariate_normal(k, jnp.zeros(4), jnp.eye(4), (500,))
    got = prng.multivariate_normal(_key(11), torch.zeros(4), torch.eye(4), (500,))
    assert _ulps(got.numpy(), ref).max() <= ULP
    a = np.random.default_rng(1).normal(size=(8, 8)).astype(np.float32)
    cov = (a @ a.T + 8 * np.eye(8)).astype(np.float32)
    mean = np.arange(8, dtype=np.float32)
    ref = jax.random.multivariate_normal(k, jnp.asarray(mean), jnp.asarray(cov), (300,))
    got = prng.multivariate_normal(_key(11), torch.as_tensor(mean),
                                   torch.as_tensor(cov), (300,))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_exponentials_within_four_ulp():
    ref = jax.random.exponential(jax.random.PRNGKey(2), (5000,))
    assert _ulps(prng.exponential(_key(2), (5000,)).numpy(), ref).max() <= ULP


@pytest.mark.parametrize("seed", range(12))
def test_choices_equal_jax(seed):
    """Without replacement from the cut-in generator's grids (30 and 15
    points, scenarios.py:129-135), and with ``p`` and replacement as
    ``gmm_noisy_init_state`` draws (sampling.py:150)."""
    k = jax.random.PRNGKey(seed)
    for grid, n in ((np.linspace(15.0, 45.0, 30), 6), (np.linspace(0.5, 5.0, 15), 15)):
        grid = grid.astype(np.float32)
        ref = jax.random.choice(k, jnp.asarray(grid), (n,), replace=False)
        got = prng.choice(_key(seed), torch.as_tensor(grid), (n,), replace=False)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    probs = jsampling.GMM_INIT_PROBS
    ref = jax.random.choice(k, jnp.asarray([1, 2, 3]), (777,), p=jnp.asarray(probs))
    got = prng.choice(_key(seed), torch.tensor([1, 2, 3]), (777,), p=probs)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="larger sample"):
        prng.choice(_key(seed), 15, (16,), replace=False)


def _flips(got, ref):
    """Elements another accept test gave another draw (far apart)."""
    return int(np.count_nonzero(np.abs(got - ref) > 1e-3 * np.maximum(1.0, np.abs(ref))))


def test_gamma_and_beta_at_the_solve_parameters():
    """Log-gamma and Beta draws at the solves' parameters (1e-8-floored
    |u| times 2 and 5) and at Beta(2e-8, 5e-8), within rtol 1e-5 + atol
    1e-6; the accept tests that round-off flipped are counted (0 here)."""
    rng = np.random.default_rng(0)
    a, b = _solve_parameters(rng, 50, 0.5)
    k = jax.random.PRNGKey(12)
    flips = 0
    ref = np.asarray(jax.random.loggamma(k, jnp.asarray(a), (200, 50)))
    got = prng.loggamma(_key(12), torch.as_tensor(a), (200, 50)).numpy()
    flips += _flips(got, ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    for aa, bb in ((a, b), (np.float32(2e-8), np.float32(5e-8))):
        ref = np.asarray(jax.random.beta(k, jnp.asarray(aa), jnp.asarray(bb), (200, 50)))
        got = prng.beta(_key(12), torch.as_tensor(aa), torch.as_tensor(bb),
                        (200, 50)).numpy()
        flips += _flips(got, ref)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    print(f"gamma / Beta: {flips} of {3 * 200 * 50} elements flipped an accept test")
    assert flips == 0


def test_kernel_twins_give_the_jax_rows():
    """``prng.draws``: row k is ``jax.random.<dist>(keys[k], (n,))``.
    ``prng.beta_draws``: row (k, b) is ``jax.random.beta(keys[k], a, b,
    shape)`` with the parameters (k, b, e mod P) and the element keys of
    ``keys[k]`` for every b, as the JAX solve's ``vmap`` over candidates
    with its key closed over draws (dynamics.py:110-114)."""
    ks = jax.random.split(jax.random.PRNGKey(21), 3)
    keys = _np(ks)
    assert np.array_equal(prng.draws(keys, 333, "bits").numpy(),
                          np.asarray(jax.vmap(lambda kk: jax.random.bits(
                              kk, (333,), jnp.uint32))(ks)).astype(np.int64))
    assert np.array_equal(prng.draws(keys, 333, "uniform").numpy(),
                          np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (333,)))(ks)))
    assert _ulps(prng.draws(keys, 333).numpy(),
                 jax.vmap(lambda kk: jax.random.normal(kk, (333,)))(ks)).max() <= ULP
    with pytest.raises(ValueError, match="dist"):
        prng.draws(keys, 3, "gamma")
    rng = np.random.default_rng(3)
    R, T, C = 4, 9, 5
    a, b = (x.reshape(3, C, T) for x in _solve_parameters(rng, 3 * C * T, 0.3))
    got = prng.beta_draws(keys, torch.as_tensor(a), torch.as_tensor(b), R * T).numpy()
    for k in range(3):
        ref = jax.vmap(lambda aa, bb: jax.random.beta(ks[k], aa, bb, (R, T)))(
            jnp.asarray(a[k]), jnp.asarray(b[k]))
        np.testing.assert_allclose(got[k], np.asarray(ref).reshape(C, R * T),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K,B,P,n", [(2, 7, 5, 20), (1, 33, 4, 8)])
def test_a_candidates_beta_row_is_its_draw_alone(K, B, P, n):
    """What kernel (b) rests on: the element keys of a row depend on the
    key and the element only, so row b of a B-candidate ``beta_draws``
    equals, bit for bit, a one-candidate call with b's parameters; at mixed
    alpha and beta (10^-8 to 10^2, below 1 among them), a NaN parameter,
    zeros and Beta(0, 0).  The rows are ``jax.vmap(jax.random.beta)`` over
    the candidates with the key closed over, within rtol 1e-5 + atol 1e-6
    (NaN where JAX gives NaN)."""
    rng = np.random.default_rng(11 + B)
    a, b = (np.float32(10.0) ** rng.uniform(-8, 2, (K, B, P)).astype(np.float32)
            for _ in range(2))
    a[0, 1, 2], b[0, 2, 3] = np.nan, np.nan
    a[-1, 3, 0] = b[-1, 3, 0] = 0.0
    a[-1, 4, 1] = 0.0
    ks = jax.random.split(jax.random.PRNGKey(31), K)
    keys, at, bt = _np(ks), torch.as_tensor(a), torch.as_tensor(b)
    got = prng.beta_draws(keys, at, bt, n).numpy()
    for c in range(B):
        alone = prng.beta_draws(keys, at[:, c:c + 1], bt[:, c:c + 1], n).numpy()
        assert np.array_equal(got[:, c], alone[:, 0], equal_nan=True), c
    assert np.isnan(got[-1, 3, 0::P]).all()
    for k in range(K):
        ref = jax.vmap(lambda aa, bb: jax.random.beta(ks[k], aa, bb, (n // P, P)))(
            jnp.asarray(a[k]), jnp.asarray(b[k]))
        np.testing.assert_allclose(got[k], np.asarray(ref).reshape(B, n), rtol=1e-5,
                                   atol=1e-6)


def test_beta_tally_counts_each_shared_key_chain_once():
    """``beta_draws``' tally (the Beta kernel's bound in chip_smoke.py):
    a key's candidates share its element key chains, so the chains' rounds
    are those of one candidate where every candidate takes the same
    parameters, and lie between the rounds every element enters and the
    candidates' sum where they differ."""
    keys = prng.split(_key(4), 2)
    rng = np.random.default_rng(5)
    a, b = (torch.as_tensor(x.reshape(2, 1, 10)) for x in _solve_parameters(rng, 20, 0.3))
    one, same, mixed = {}, {}, {}
    prng.beta_draws(keys, a, b, 40, one)
    prng.beta_draws(keys, a.expand(2, 6, 10), b.expand(2, 6, 10), 40, same)
    a6, b6 = (torch.as_tensor(x.reshape(2, 6, 10)) for x in _solve_parameters(rng, 120, 0.3))
    prng.beta_draws(keys, a6, b6, 40, mixed)
    for name in ("outer", "inner"):
        assert one[f"{name}_chains"] == one[name]
        assert (same[name], same[f"{name}_chains"]) == (6 * one[name], one[name])
    assert one["outer"] >= 2 * 2 * 40
    assert 2 * 2 * 40 <= mixed["outer_chains"] < mixed["outer"]
    assert mixed["inner_chains"] < mixed["inner"]
    assert "group" not in mixed


def test_wrappers_take_the_twins_on_the_cpu_and_check_their_inputs():
    keys = prng.split(_key(1), 2)
    assert torch.equal(ops.prng_draws(keys, 10), prng.draws(keys, 10))
    a = torch.full((2, 1, 5), 0.3)
    assert torch.equal(ops.prng_beta(keys, a, a, 10), prng.beta_draws(keys, a, a, 10))
    with pytest.raises(ValueError, match="int64"):
        ops.prng_draws(keys.to(torch.int32), 10)
    with pytest.raises(ValueError, match="multiple"):
        ops.prng_beta(keys, a, a, 7)
    with pytest.raises(ValueError, match="one"):
        ops.prng_beta(keys, a, a[:, :, :4], 10)


def _small_cfg(noise="gaussian"):
    cfg = jc.fastrt_workload(num_reduced=3, num_obs=2, num_prime=12, noise=noise)
    return cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=12, maxiter_cem=2),
                       beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12,
                                                    maxiter=2))


@pytest.mark.parametrize("strategy", ["prefactored", "exact"])
def test_jax_noise_draws_the_jax_key_chain(strategy):
    """Every family of one solve (``record_solve_draws``) equals the JAX key
    chain's draws (tests/test_torch_noise.py::jax_draws, Frenet initial
    states included) within 4 ulp; Beta draws as ``jax_beta``."""
    cfg = _small_cfg().replace(solve_strategy=strategy)
    tcfg = to_torch_cfg(cfg)
    noise = JaxNoise("cpu")
    got, _ = record_solve_draws(noise, tcfg, 7)
    ref = jax_draws(cfg, 7)
    ref["init_state_z"] = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(7))[0], (init_state_count(tcfg), 4)))
    for name, arr in got.items():
        assert arr.shape == ref[name].shape, name
        assert _ulps(arr, ref[name]).max() <= ULP, name
    alpha, beta = (np.float32(s) * np.abs(np.random.default_rng(1).normal(
        size=(2, 6, 12))).astype(np.float32) + np.float32(1e-8) for s in (2, 5))
    got = noise.rollout_beta(noise.keys([7], 2)[:, 1], 3, torch.as_tensor(alpha)[:, None],
                             torch.as_tensor(beta)[:, None])[:, 0]
    np.testing.assert_allclose(got.numpy(), jax_beta(7, 1, 3, alpha, beta),
                               rtol=1e-5, atol=1e-6)


def test_jax_noise_chunks_equal_per_seed_draws_and_the_gmm_draws_equal_jax():
    noise, seeds = JaxNoise("cpu"), [3, 11, 40]
    keys = noise.keys(seeds, 3)[:, 2]
    alone = lambda s: noise.keys([s], 3)[:, 2]
    eps = noise.rollout_eps(keys, 3, 7)
    for i, s in enumerate(seeds):
        for a, b in zip(eps, noise.rollout_eps(alone(s), 3, 7)):
            assert torch.equal(a[i], b[0])
        assert torch.equal(noise.cem_z(keys, 5, 8)[i], noise.cem_z(alone(s), 5, 8)[0])
    alpha = torch.rand(2, 3, 4, 7) * 0.5 + 1e-8
    chunk = noise.rollout_beta(keys, 3, alpha, 2.5 * alpha)
    for i, s in enumerate(seeds):
        assert torch.equal(chunk[:, i], noise.rollout_beta(
            alone(s), 3, alpha[:, i:i + 1], 2.5 * alpha[:, i:i + 1])[:, 0])
    key = jax.random.split(jax.random.PRNGKey(9))[0]
    z, modes = noise.gmm_init_draws(9, 40, jsampling.GMM_INIT_PROBS)
    assert _ulps(z.numpy(), jax.random.normal(key, (40, 4))).max() <= ULP
    ref = jax.random.choice(key, jnp.asarray([1, 2, 3]), (40,),
                            p=jnp.asarray(jsampling.GMM_INIT_PROBS))
    assert np.array_equal(modes.numpy(), np.asarray(ref))


@pytest.mark.parametrize("noise_kind", ["gaussian", "beta"])
def test_jax_noise_mc_draws_equal_the_jax_validator_draws(noise_kind):
    cfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=30, mode="cvar",
                             noise=noise_kind, noise_level=0.3)
    jws = j_build_workspace(cfg)
    cx, cy = _solves(jws, 3, np.random.default_rng(5))
    seed, n_mc = 4, 60
    ref = jax_mc_draws(cfg, jws, jnp.asarray(cx), jnp.asarray(cy), seed, n_mc)
    T, params = cfg.horizon.num_prime, None
    if noise_kind == "beta":
        # Beta parameters as the JAX validator sets them (validate.py:50-54),
        # handed to both
        a = np.abs(np.random.default_rng(6).normal(size=(2, 3, T))).astype(np.float32)
        a[0, :, 0] = 0.0
        nz = cfg.noise
        alpha = np.stack((nz.beta_a * a[0], nz.beta_a * a[1] + 1e-5)).astype(np.float32)
        beta = np.stack((nz.beta_b * a[0], nz.beta_b * a[1] + 1e-5)).astype(np.float32)
        params = (torch.as_tensor(alpha), torch.as_tensor(beta))
        keys = jax.random.split(jax.random.PRNGKey(seed), 3)
        ref["mc_beta"] = np.stack([[np.asarray(jax.random.beta(
            jax.random.split(keys[r], 3)[ch], alpha[ch, r], beta[ch, r], (n_mc, T)))
            for ch in (0, 1)] for r in range(3)])
    d_acc, d_steer, eps = JaxNoise("cpu").mc_draws(seed, range(3), n_mc, T, params)
    assert _ulps(eps.numpy(), ref["mc_eps_const"]).max() <= ULP
    if noise_kind == "gaussian":
        assert _ulps(d_acc.numpy(), ref["mc_eps_acc"]).max() <= ULP
        assert _ulps(d_steer.numpy(), ref["mc_eps_steer"]).max() <= ULP
    else:
        got = torch.stack((d_acc, d_steer), 1).numpy()
        assert np.isnan(got[:, 0, :, 0]).all() and np.isnan(ref["mc_beta"][:, 0, :, 0]).all()
        np.testing.assert_allclose(got, ref["mc_beta"], rtol=1e-5, atol=1e-6)


def jax_prng_reference():
    """JAX's draws for fixed keys (kernel a: bits, uniforms, normals of 4
    keys x 1,000; kernel b: Beta draws of 2 keys x 3 candidates x 40 at the
    solves' parameters and at Beta(2e-8, 5e-8)) and the JAX package's
    full-width fastrt ``mmd_opt`` solve (gaussian 0.1, N = 10, 6 obstacles,
    ts 50) of idx_mpc 5 on the first blocking scenario."""
    ks = jnp.concatenate((jax.random.PRNGKey(0)[None],
                          jax.random.split(jax.random.PRNGKey(1), 3)))
    out = {"keys": np.asarray(ks).astype(np.int64)}
    for name, fn in (("bits", lambda k: jax.random.bits(k, (1000,), jnp.uint32)),
                     ("uniform", lambda k: jax.random.uniform(k, (1000,))),
                     ("normal", lambda k: jax.random.normal(k, (1000,)))):
        out[name] = np.asarray(jax.vmap(fn)(ks))
    out["bits"] = out["bits"].astype(np.int64)
    a, b = (x.reshape(2, 3, 10) for x in
            _solve_parameters(np.random.default_rng(7), 60, 0.3))
    a[1, 2], b[1, 2] = np.float32(2e-8), np.float32(5e-8)
    out["beta_keys"] = out["keys"][2:]
    out["beta_alpha"], out["beta_beta"] = a, b
    out["beta"] = np.stack([np.asarray(jax.vmap(
        lambda aa, bb: jax.random.beta(ks[2 + k], aa, bb, (4, 10)))(
            jnp.asarray(a[k]), jnp.asarray(b[k]))).reshape(3, 40) for k in range(2)])
    cfg = jc.fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                             noise="gaussian", noise_level=0.1)
    js = JSolver(cfg)
    xts, yts = blocking_scenarios(js.ws.tot_time, 1, n_obs=6)
    r = js.solve(5, jnp.asarray(INIT), jnp.asarray(MEAN), jnp.asarray(COV),
                 xts[0], yts[0], 15.0)
    acc, steer = _controls(js.ws, cfg, r.cx, r.cy)
    out.update(solve_idx=np.int64(5), solve_x_obs=np.asarray(xts[0]),
               solve_y_obs=np.asarray(yts[0]), solve_cx=np.asarray(r.cx),
               solve_cy=np.asarray(r.cy), solve_acc=acc, solve_steer=steer,
               solve_res=np.asarray(r.res), solve_risk_obs=np.asarray(r.risk_obs))
    return out


def test_reference_file_holds_the_jax_draws():
    """The draws in prng_reference.npz are JAX's (the solve part is held on
    the card by chip_smoke.py phase 15), and the twins give them."""
    with np.load(REFERENCE) as f:
        ref = dict(f)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    assert np.array_equal(ref["keys"][1:], np.asarray(ks).astype(np.int64))
    assert np.array_equal(ref["bits"][1:], np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (1000,), jnp.uint32))(ks)).astype(np.int64))
    keys = torch.as_tensor(ref["keys"])
    assert np.array_equal(prng.draws(keys, 1000, "bits").numpy(), ref["bits"])
    assert np.array_equal(prng.draws(keys, 1000, "uniform").numpy(), ref["uniform"])
    assert _ulps(prng.draws(keys, 1000).numpy(), ref["normal"]).max() <= ULP
    got = prng.beta_draws(torch.as_tensor(ref["beta_keys"]),
                          torch.as_tensor(ref["beta_alpha"]),
                          torch.as_tensor(ref["beta_beta"]), 40)
    np.testing.assert_allclose(got.numpy(), ref["beta"], rtol=1e-5, atol=1e-6)
    assert ref["solve_cx"].shape == (11,) and np.isfinite(ref["solve_res"]).all()


@pytest.mark.parametrize("iters,idx_mpc,scenario", [(1, 42, 0), (3, 7, 3)])
def test_solve_on_default_noise_matches_jax(iters, idx_mpc, scenario):
    """A gaussian ``mmd_opt`` solve of idx_mpc with the port's default noise
    against the JAX package's solve of the same idx_mpc: the controls within
    1e-3 and the CEM's traces as tests/test_torch_solver.py holds them on
    injected draws."""
    cfg = _cfg(iters)
    js = JSolver(cfg)
    ts = TSolver(to_torch_cfg(cfg), device="cpu", ws=workspace_from_numpy(
        {n: np.asarray(getattr(js.ws, n)) for n in js.ws._fields}, "cpu"))
    assert isinstance(ts.noise, JaxNoise)
    xts, yts = blocking_scenarios(js.ws.tot_time, scenario + 1)
    xo, yo = np.asarray(xts[scenario]), np.asarray(yts[scenario])
    ref = js.solve(idx_mpc, jnp.asarray(INIT), jnp.asarray(MEAN), jnp.asarray(COV),
                   jnp.asarray(xo), jnp.asarray(yo), 15.0)
    got = ts.solve(idx_mpc, INIT, MEAN, COV, xo, yo, 15.0)
    if iters == 1:
        _assert_one_iteration(cfg, js.ws, ref, got)
    a_r, s_r = _controls(js.ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(js.ws, cfg, jnp.asarray(got.cx.numpy()),
                         jnp.asarray(got.cy.numpy()))
    assert max(np.abs(a_r - a_m).max(), np.abs(s_r - s_m).max()) <= 1e-3
    for name in ("res", "risk_obs", "res_beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_static_beta_solve_on_default_noise_matches_jax():
    """The record's static Beta 0.3 cell at N = 5 (one outer iteration at a
    cut budget): the port's own Beta draws against the JAX solve's, held as
    tests/test_torch_solver.py holds the injected ones."""
    cfg, ws, ref, xo, yo = _record_cell_jax(5)
    ts = TSolver(to_torch_cfg(cfg), device="cpu", ws=workspace_from_numpy(
        {n: np.asarray(getattr(ws, n)) for n in ws._fields}, "cpu"))
    got = ts.solve(42, INIT, MEAN, COV, xo, yo, 15.0)
    a_r, s_r = _controls(ws, cfg, ref.cx, ref.cy)
    a_m, s_m = _controls(ws, cfg, jnp.asarray(got.cx.numpy()), jnp.asarray(got.cy.numpy()))
    assert max(np.abs(a_r - a_m).max(), np.abs(s_r - s_m).max()) <= 1e-3
    for name in ("risk_obs", "mean_param", "cov_param", "res", "sigma"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(ref.beta),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar"])
def test_frenet_step_on_default_noise_matches_jax(mode):
    """One FrenetSolver step (noisy initial states included) on default
    noise against the JAX Frenet solve of the same idx_mpc."""
    cfg = frenet_cfg(mode, 2)
    js = jax_solver(cfg)
    jframe, tframe, init, xo, yo = _scenario()
    ref = js.solve(IDX, jnp.asarray(init), jnp.asarray(MEAN0), jnp.asarray(COV0),
                   jnp.asarray(xo), jnp.asarray(yo), 10.0, jframe)
    ts = TFrenetSolver(to_torch_cfg(cfg), device="cpu", ws=workspace_from_numpy(
        {n: np.asarray(getattr(js.ws, n)) for n in js.ws._fields}, "cpu"))
    got = ts.solve(IDX, init, MEAN0, COV0, xo, yo, 10.0, tframe)
    for name in ("v_best", "steering_best"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    for name in ("risk_obs", "res", "mean_param", "cov_param"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("noise_kind", ["gaussian", "beta"])
def test_validator_on_default_noise_counts_as_jax(noise_kind):
    """The validator with its default noise against the JAX validator at the
    same seed: equal counts and fractions."""
    kw = dict(noise=noise_kind, noise_level=0.2 if noise_kind == "gaussian" else 0.4,
              acc_const_noise=0.05, steer_const_noise=0.02)
    cfg = jc.static_workload(num_reduced=3, num_obs=2, num_prime=30, mode="cvar", **kw)
    jws = j_build_workspace(cfg)
    S, n_mc, seed = 4, 300, 7
    cx, cy = _solves(jws, S, np.random.default_rng(11))
    xo, yo = _obstacles(S, cfg.horizon.num)
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    ref = j_core(cfg, jws, n_mc)(*map(jnp.asarray, (cx, cy, VINIT, xo, yo)), keys)
    tcfg = to_torch_cfg(cfg)
    got = make_validator_core(tcfg, build_workspace(tcfg, "cpu"), n_mc, chunk=3)(
        cx, cy, VINIT, xo, yo, seed, range(S))
    for name in ("coll_count", "lane_count", "coll_fraction"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert 0 < int(got.coll_count.max()) < n_mc


@pytest.mark.parametrize("mode", ["mmd_opt", "cvar"])
def test_sweep_accepts_as_jax_on_default_noise(tmp_path, mode):
    """With no injected draws the port's sweep accepts exactly the scenarios
    the JAX sweep accepts, with the same risks (rtol 1e-4), some passing
    the threshold and some not (test_torch_pipeline.py's size)."""
    kw = dict(workload="static", mode=mode, noise="gaussian", noise_level=0.1,
              num_reduced=3, num_obs=6, num_prime=50, num_configs=8, chunk=4,
              accept_all=True, inner_budget=(16, 2), outer_budget=(16, 4))
    ref = j_sweep.run_sweep(out_root=str(tmp_path / "j"), **kw).concatenated()
    got = sweep.run_sweep(out_root=str(tmp_path / "t"), device="cpu",
                          **kw).concatenated()
    threshold = sweep.accept_threshold(mode, static_workload().risk.ker_wt)
    accepted = ref["risk_obs"] <= threshold
    assert 0 < accepted.sum() < len(accepted)
    np.testing.assert_array_equal(got["seeds"], ref["seeds"])
    np.testing.assert_array_equal(got["risk_obs"] <= threshold, accepted)
    np.testing.assert_allclose(got["risk_obs"], ref["risk_obs"], rtol=1e-4, atol=1e-3)


def test_record_check_reads_the_record_and_validates_its_stores(tmp_path, monkeypatch):
    """``utils/record_check.py`` at a tiny sweep (8 configs, 16 x 2 budgets)
    on the CPU: the record's counts (43 and 59 accepted, n_common 37) as
    its stores hold them, the record's stores validated by the port, and
    ``beside`` a run's own stores: every scenario shared."""
    from mpc_mmd_tpu_torch.utils import record_check as rc
    monkeypatch.setattr(rc, "SWEEP", dict(rc.SWEEP, num_configs=8, inner_budget=(16, 2),
                                          outer_budget=(16, 2)))
    out = rc.record_check(str(tmp_path), device="cpu", n_mc=100,
                          beside=str(tmp_path / "data"))
    assert (out["mmd_opt"]["record_accepted"], out["cvar"]["record_accepted"],
            out["record_n_common"]) == (43, 59, 37)
    for mode in ("mmd_opt", "cvar"):
        m = out[mode]
        assert m["both"] + m["only_record"] == m["record_accepted"]
        assert 0.0 < m["mc_band_pct"] < 5.0
        assert 0.0 <= m["record_stores_validated_by_port_pct"] <= 100.0
        assert m["beside"] == {"accepted": m["accepted"], "both": m["accepted"],
                               "only_this": 0, "only_beside": 0,
                               "record_among_only_this": 0,
                               "record_among_only_beside": 0}
    assert (tmp_path / "record_check.json").exists()


def test_record_check_sweeps_in_cpu_ranks_as_in_one_process(tmp_path, monkeypatch):
    """``--workers 2`` (two gloo ranks a mode, both modes at once) gives
    the stores of the one-process sweep, at a tiny sweep (8 configs,
    chunks of 2, 8 x 2 budgets)."""
    from mpc_mmd_tpu_torch.utils import record_check as rc
    sweep = dict(rc.SWEEP, num_configs=8, chunk=2, scenario_chunk=2,
                 inner_budget=(8, 2), outer_budget=(8, 2))
    monkeypatch.setattr(rc, "SWEEP", sweep)
    for m in rc.MODES:
        rc.run_sweep(mode=m, out_root=str(tmp_path / "one"), device="cpu", **sweep)
    rc._sweep_ranks(str(tmp_path / "two"), 2)
    for m in rc.MODES:
        one, two = (rc.ResultStore(rc.store_root(str(tmp_path / d), m, sweep))
                    for d in ("one", "two"))
        assert two.meta["num_configs"] == 8
        a, b = one.concatenated(), two.concatenated()
        order = np.argsort(b["seeds"])
        np.testing.assert_array_equal(np.sort(a["seeds"]), b["seeds"][order])
        np.testing.assert_allclose(a["risk_obs"][np.argsort(a["seeds"])],
                                   b["risk_obs"][order], rtol=1e-5, atol=1e-4)
