"""PyTorch port vs JAX package: the CVaR and SAA risks.

``cvar_reduce`` takes the linear-interpolation quantile of ``jnp.quantile``
and a ``>=`` mask, so ties at the quantile and all-zero rows (most
rollouts violate nothing) are the cases to hold.  Tolerance rtol 1e-6 +
atol 1e-7: the two quantiles interpolate in float32 with the same formula,
and the masked means sum at most a few hundred values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import risk as jrisk
from mpc_mmd_tpu_torch import risk as trisk
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)


def _violations(rng, shape):
    """Rows of every kind the solve meets: mostly zero, ties, distinct."""
    x = np.maximum(rng.normal(0, 1, shape), 0.0).astype(np.float32)
    x[0] = 0.0                                    # all-zero row
    x[1] = np.round(x[1])                         # ties
    x[2] = 0.0
    x[2, -1] = 0.7                                # one violation
    x[3] = 0.5                                    # all equal, non-zero
    x[4, : shape[-1] // 2] = 0.0
    return x


@pytest.mark.parametrize("R", [4, 10, 100])
@pytest.mark.parametrize("alpha", [0.98, 0.9, 0.5])
def test_cvar_and_saa_reduce_match_jax(rng, R, alpha):
    x = _violations(rng, (8, R))
    ref = np.asarray(jrisk.cvar_reduce(jnp.asarray(x), alpha))
    got = trisk.cvar_reduce(torch.from_numpy(x), alpha).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0 and got[3] == np.float32(0.5)
    np.testing.assert_array_equal(
        trisk.saa_reduce(torch.from_numpy(x), 10).numpy(),
        np.asarray(jrisk.saa_reduce(jnp.asarray(x), 10)))
    # any leading batch, as the solver's (C,) candidates
    np.testing.assert_allclose(
        trisk.cvar_reduce(torch.from_numpy(x.reshape(2, 4, R)), alpha).numpy(),
        ref.reshape(2, 4), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("workload", ["static_workload", "dynamic_workload"])
def test_cvar_and_saa_risks_match_jax(rng, workload):
    cfg = getattr(jc, workload)(num_reduced=4, num_obs=2, num_prime=20)
    C, R, T = 6, 4, 20
    xr = rng.normal(10, 4, (C, R, T)).astype(np.float32)
    yr = rng.normal(-1, 1.5, (C, R, T)).astype(np.float32)
    xr[0] = 100.0                                  # clear of the obstacles
    xo = rng.normal(10, 2, (2, T)).astype(np.float32)
    yo = rng.normal(-1, 1, (2, T)).astype(np.float32)
    tcfg = to_torch_cfg(cfg)
    t = lambda *a: map(torch.from_numpy, a)
    for name in ("cvar_obs", "saa_obs"):
        ref = jax.vmap(lambda x, y: getattr(jrisk, name)(
            cfg, x, y, jnp.asarray(xo), jnp.asarray(yo)))(jnp.asarray(xr),
                                                          jnp.asarray(yr))
        got = getattr(trisk, name)(tcfg, *t(xr, yr, xo, yo))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        assert got[0] == 0.0
    for name in ("cvar_lane", "saa_lane"):
        ref = jax.vmap(lambda y: getattr(jrisk, name)(cfg, y))(jnp.asarray(yr))
        got = getattr(trisk, name)(tcfg, *t(yr))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


KINDS = ["laplace", "gaussian", "matern52"]


@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_jax(rng, kind):
    """pairwise_l2sq (the matmul expansion clamped at 0), kernel_of and
    mmd_vs_zero of every kind, at rtol 1e-5."""
    from mpc_mmd_tpu import kernels as jk
    from mpc_mmd_tpu_torch import kernels as tk
    A = rng.normal(0, 3, (4, 9, 22)).astype(np.float32)
    B = rng.normal(0, 3, (4, 7, 22)).astype(np.float32)
    A[0, 1] = B[0, 2]                            # a zero distance
    for name in ("pairwise_l1", "pairwise_l2sq"):
        ref = np.asarray(getattr(jk, name)(jnp.asarray(A), jnp.asarray(B)))
        got = getattr(tk, name)(torch.from_numpy(A), torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3, err_msg=name)
    assert float(tk.pairwise_l2sq(torch.from_numpy(A), torch.from_numpy(A)).min()) >= 0.0
    d1 = np.asarray(jk.pairwise_l1(jnp.asarray(A), jnp.asarray(B))) / 20.0
    d2 = np.asarray(jk.pairwise_l2sq(jnp.asarray(A), jnp.asarray(B))) / 100.0
    sigma = rng.uniform(0.05, 5.0, (4, 1, 1)).astype(np.float32)
    for s in (sigma, 0.7):
        ref = np.asarray(jk.kernel_of(kind, s if np.isscalar(s) else jnp.asarray(s),
                                      jnp.asarray(d1), jnp.asarray(d2)))
        got = tk.kernel_of(kind, s if np.isscalar(s) else torch.from_numpy(s),
                           torch.from_numpy(d1), torch.from_numpy(d2)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    beta = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    cost = np.maximum(rng.normal(0, 0.5, (6, 5)), 0).astype(np.float32)
    sig = rng.uniform(0.01, 5.0, 6).astype(np.float32)
    ref = np.asarray(jk.mmd_vs_zero(jnp.asarray(beta), jnp.asarray(cost),
                                    jnp.asarray(sig), 1000.0, kind=kind))
    got = tk.mmd_vs_zero(torch.from_numpy(beta), torch.from_numpy(cost),
                         torch.from_numpy(sig), 1000.0, kind=kind).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError):
        tk.kernel_of("cosine", 1.0, torch.zeros(1), torch.zeros(1))


@pytest.mark.parametrize("kind", ["gaussian", "matern52"])
def test_mmd_risks_of_other_kernels_match_jax(rng, kind):
    import dataclasses
    cfg = jc.static_workload(num_reduced=4, num_obs=2, num_prime=20)
    cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kind))
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
