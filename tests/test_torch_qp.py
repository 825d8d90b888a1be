"""PyTorch port vs JAX package: workspace, guess QP, projection, refit.

Tolerances: the workspace is the same float64 host arithmetic rounded to
float32 (rtol 1e-6); the deterministic stages agree to float32 round-off,
held at the bounds of tests/test_parity.py:108-116 (coefficients 2e-3,
residuals and multipliers 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu import projection as jproj
from mpc_mmd_tpu import qp as jqp
from mpc_mmd_tpu_torch import projection as tproj
from mpc_mmd_tpu_torch import qp as tqp
from test_torch_noise import to_torch_cfg

torch.set_num_threads(1)


def _ws_numpy(ws):
    return {name: np.asarray(getattr(ws, name)) for name in ws._fields}


@pytest.mark.parametrize("num_prime", [20, 50])
def test_build_workspace_matches_jax(num_prime):
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2, num_prime=num_prime)
    ref = jqp.build_workspace(cfg)
    got = tqp.build_workspace(to_torch_cfg(cfg))
    assert got._fields == ref._fields
    for name in ref._fields:
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_workspace_from_numpy_round_trips():
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2)
    arrays = _ws_numpy(jqp.build_workspace(cfg))
    ws = tqp.workspace_from_numpy(arrays, "cpu")
    for name, a in arrays.items():
        np.testing.assert_array_equal(getattr(ws, name).numpy(), a)
    again = tqp.workspace_from_numpy(
        {n: getattr(ws, n).numpy() for n in ws._fields}, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(ws, again))
    with pytest.raises(KeyError):
        tqp.workspace_from_numpy({"P": arrays["P"]}, "cpu")


def _stage_inputs(rng, nb):
    params = np.concatenate((rng.normal(15, 4, (nb, 4)),
                             rng.normal(0, 10, (nb, 4))), axis=1)
    init = np.asarray([0.0, 1.75, 5.0, 0.3, 0.1, -0.2])
    return params.astype(np.float32), init.astype(np.float32)


def test_guess_projection_refit_match_jax(rng):
    cfg = jc.fastrt_workload(num_reduced=4, num_obs=2)
    nb = cfg.cem.num_batch
    tcfg = to_torch_cfg(cfg)
    jws = jqp.build_workspace(cfg)
    tws = tqp.workspace_from_numpy(_ws_numpy(jws), "cpu")
    params, init = _stage_inputs(rng, nb)

    jbx, jby = jqp.boundary_vectors(cfg, jnp.asarray(init))
    tbx, tby = tqp.boundary_vectors(tcfg, torch.from_numpy(init))
    np.testing.assert_array_equal(tbx.numpy(), np.asarray(jbx))
    np.testing.assert_array_equal(tby.numpy(), np.asarray(jby))

    jgx, jgy = jqp.compute_guess(cfg, jws, jnp.asarray(params), jbx, jby)
    tgx, tgy = tqp.compute_guess(tcfg, tws, torch.from_numpy(params), tbx, tby)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(tgy.numpy(), np.asarray(jgy), rtol=1e-5, atol=2e-3)

    # two chained projections: the second is warm-started from the first's
    # multipliers and slack, as the solver does across outer iterations
    nvar, num = cfg.horizon.nvar, cfg.horizon.num
    jl = (jnp.zeros((nb, nvar)), jnp.zeros((nb, nvar)),
          jnp.zeros((nb, 2 * (num - 1))))
    tl = tuple(torch.from_numpy(np.array(a)) for a in jl)
    zo = jnp.zeros((2, num))
    for _ in range(2):
        jp = jproj.project(cfg, jws, jgx, jgy, jbx, jby, *jl, zo, zo)
        tp = tproj.project(tcfg, tws, torch.from_numpy(np.array(jgx)),
                           torch.from_numpy(np.array(jgy)), tbx, tby, *tl)
        for name in ("c_x", "c_y"):
            np.testing.assert_allclose(getattr(tp, name).numpy(),
                                       np.asarray(getattr(jp, name)),
                                       atol=2e-3, err_msg=name)
        for name in ("res_norm", "lamda_x", "lamda_y", "s_lane", "xdot",
                     "ydot", "xddot", "yddot"):
            r = np.asarray(getattr(jp, name))
            np.testing.assert_allclose(getattr(tp, name).numpy(), r,
                                       atol=1e-4 * max(1.0, np.abs(r).max()),
                                       err_msg=name)
        jl = (jp.lamda_x, jp.lamda_y, jp.s_lane)
        tl = tuple(torch.from_numpy(np.array(a)) for a in jl)

    x = rng.normal(0, 20, (3, 7, cfg.horizon.num_prime)).astype(np.float32)
    y = rng.normal(0, 2, (3, 7, cfg.horizon.num_prime)).astype(np.float32)
    jcx, jcy = jqp.refit_coefficients(jws, jnp.asarray(x), jnp.asarray(y))
    tcx, tcy = tqp.refit_coefficients(tws, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(tcx.numpy(), np.asarray(jcx), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tcy.numpy(), np.asarray(jcy), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale", [0.5, 3.0, 10.0])
def test_unwrap_matches_jnp_unwrap(rng, scale):
    """Random walks whose steps cross +-pi, plus exact +-pi steps (the
    boundary rule) and a jump of several periods."""
    steps = rng.normal(0, scale, (6, 40))
    p = np.cumsum(steps, axis=1)
    p = np.arctan2(np.sin(p), np.cos(p)).astype(np.float32)
    p[0, :4] = np.float32([0.0, np.pi, 0.0, -np.pi])
    p[1, :3] = np.float32([0.1, 0.1 + 7 * np.pi, 0.2])
    got = tproj.unwrap(torch.from_numpy(p)).numpy()
    ref = np.asarray(jnp.unwrap(jnp.asarray(p), axis=-1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # and along the last axis of a 3-D batch
    p3 = p.reshape(2, 3, 40)
    np.testing.assert_allclose(tproj.unwrap(torch.from_numpy(p3)).numpy(),
                               np.asarray(jnp.unwrap(jnp.asarray(p3), axis=-1)),
                               rtol=0, atol=1e-5)
