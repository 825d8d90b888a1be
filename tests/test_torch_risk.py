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
