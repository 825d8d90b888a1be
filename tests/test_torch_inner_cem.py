"""Kernel (c)'s wrapper ``ops.inner_cem`` against the JAX package's inner
beta-CEM, the routing of ``select_reduced_set_batched`` to it under every
(selection, elite-carry) pair, and the argument its forms rest on: each
selection's chain with elite-carry gives the chain without it bit for bit.

On the CPU the wrapper runs its plain version (``inner_cem_plain``), the
chain the kernel replaces on the card; the card-only cases in
``tests/test_torch_gpu.py`` hold the kernel against that chain.  Both
packages get identical mother-rollout coefficients and the same inner
draws (the port through ``FixedNoise``, rebuilt from the JAX key chain),
the port's through ``reduced_set.inner_inputs``.  Index-derived outputs
(which rollouts form the reduced set, in which slot order) must be equal
exactly; float outputs agree at rtol 1e-4 + atol 1e-6, the tolerances of
``tests/test_torch_reduced_set.py``.  The first batch may carry a NaN
lane (row 1) or tied |beta| (row 2), edited into the JAX draw of both
packages.  A NaN lane is compared at one iteration only: the JAX package
gathers the elites with one-hot products, through which a NaN lane of any
row reaches every elite (0 x NaN), where the port's gather takes the
elites' rows alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu import config as jc
from mpc_mmd_tpu.reduced_set import select_reduced_set_batched as j_select
from mpc_mmd_tpu_torch import reduced_set
from mpc_mmd_tpu_torch.noise import FixedNoise
from mpc_mmd_tpu_torch.ops import inner_cem
from mpc_mmd_tpu_torch.ops.inner_cem import KINDS, SELECTIONS, inner_cem_plain, take_rows
from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
from test_torch_noise import jax_draws, to_torch_cfg

torch.set_num_threads(1)

C = 3


def _cfg(k, maxiter, kind):
    """C 3 candidates, S 12 samples (n_el 3), M = k^2 mother rollouts."""
    cfg = jc.static_workload(num_reduced=k, num_obs=2, num_prime=15)
    return cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kind),
                       beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=12,
                                                    maxiter=maxiter))


def _edit_first_batch(monkeypatch, cfg, edit):
    """The JAX draw of the first batch (S, M+1) with row 1's lane 7 NaN or
    row 2's |beta| tied (rounded to integers), for both packages."""
    if edit is None:
        return
    S, M = cfg.beta_cem.num_samples_cem, cfg.risk.num_mother
    normal = jax.random.normal

    def edited(key, shape=(), *a, **kw):
        x = normal(key, shape, *a, **kw)
        if tuple(shape) == (S, M + 1):
            x = (x.at[1, 7 % M].set(jnp.nan) if edit == "nan_lane"
                 else x.at[2, :M].set(jnp.round(x[2, :M])))
        return x

    monkeypatch.setattr(jax.random, "normal", edited)


def _inputs(rng, M, T=15, nvar=11):
    """cx, cy, x_roll, y_roll.  The coefficients' spread (0.3) puts the
    kernel values between 0 and 1: at a spread of 1 the L1 distances of 22
    features are so large against the bandwidths that K_red is about the
    identity for every sample, and most samples' costs then tie within
    round-off (at 1/8 with k = 4), which orders the elites by round-off."""
    return tuple(rng.normal(0, s, (C, M, n)).astype(np.float32)
                 for s, n in ((0.3, nvar), (0.3, nvar), (5, T), (1, T)))


def _port(cfg, cx, cy):
    """The port's inner CEM inputs from the JAX package's draws."""
    bc, M = cfg.beta_cem, cfg.risk.num_mother
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    return reduced_set.inner_inputs(to_torch_cfg(cfg), torch.from_numpy(cx),
                                    torch.from_numpy(cy), draws)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("maxiter,edit", [(1, None), (3, None), (1, "nan_lane"),
                                          (1, "ties"), (3, "ties")])
def test_inner_cem_matches_jax(rng, monkeypatch, kind, k, maxiter, edit):
    monkeypatch.delenv("MPC_MMD_ELITE_CARRY", raising=False)
    cfg = _cfg(k, maxiter, kind)
    _edit_first_batch(monkeypatch, cfg, edit)
    cx, cy, xr, yr = _inputs(rng, cfg.risk.num_mother)
    ref = j_select(cfg, *map(jnp.asarray, (cx, cy, xr, yr)), selection="xla")
    inputs = _port(cfg, cx, cy)
    if edit == "nan_lane":
        assert bool(torch.isnan(inputs.samples0_row[1]).any())
    bc = cfg.beta_cem
    beta, sigma, idx, res = inner_cem(*inputs, k, bc.num_ellite, bc.rho_beta,
                                      bc.qp_reg, kind)
    assert idx.dtype == torch.int64 and idx.shape == (C, k)
    for name, got in (("x_red", xr), ("y_red", yr)):
        np.testing.assert_array_equal(
            take_rows(torch.from_numpy(got), idx).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)
    assert res.shape == (C, maxiter)
    for name, got in (("beta", beta), ("sigma", sigma), ("res", res)):
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(beta.sum(-1).numpy(), 1.0, atol=1e-4)


def test_inner_cem_refuses_what_neither_version_takes(rng):
    """Shapes that do not match, no elites or no fresh rows, k past M, an
    unknown kernel kind, D2 where the kind reads none (or none where it
    does); and a tensor off the CPU that is no CUDA tensor raises instead
    of taking the plain version."""
    cfg = _cfg(3, 2, "laplace")
    cx, cy, _, _ = _inputs(rng, cfg.risk.num_mother)
    D, D2, s0, A, Z, floor = _port(cfg, cx, cy)
    n_el = cfg.beta_cem.num_ellite
    good = dict(D=D, D2=D2, samples0_row=s0, A_all=A, Zf_all=Z, lane_floor=floor,
                k=3, n_el=n_el, rho=1.0, reg=0.05, kind="laplace")
    inner_cem(**good)
    coeffs = tuple(map(torch.from_numpy, (cx, cy)))
    inner_cem(**good, selection="g", coeffs=coeffs)
    inner_cem(**good, selection="fused", carry=False)
    for bad in (dict(D=D[:, :, :-1]), dict(D2=D), dict(kind="gaussian"),
                dict(kind="cauchy"), dict(samples0_row=s0[:, :-1]),
                dict(A_all=A[:, :-1]), dict(Zf_all=Z[:1]), dict(lane_floor=floor[:-1]),
                dict(n_el=0), dict(n_el=s0.shape[0]), dict(k=D.shape[-1] + 1),
                dict(A_all=A[:0], Zf_all=Z[:0]),
                # the forms: an unknown selection, "fused" with elite-carry,
                # "fused" and "g" under another kernel, "g" without coeffs
                dict(selection="gather"), dict(selection="fused"),
                dict(selection="fused", carry=False, D2=D, kind="gaussian"),
                dict(selection="g", coeffs=coeffs, D2=D, kind="matern52"),
                dict(selection="g"), dict(selection="g", coeffs=coeffs[:1]),
                dict(selection="g", coeffs=(coeffs[0][:, :-1], coeffs[1]))):
        with pytest.raises(ValueError):
            inner_cem(**dict(good, **bad))
    with pytest.raises(ValueError, match="CUDA"):
        inner_cem(**dict(good, D=D.to("meta")))


@pytest.mark.parametrize("kind", ["laplace", "gaussian"])
@pytest.mark.parametrize("selection", SELECTIONS)
@pytest.mark.parametrize("carry", ["1", "0"])
def test_select_routes_every_selection_to_inner_cem(rng, monkeypatch, kind, selection,
                                                    carry):
    """``select_reduced_set_batched`` calls ``ops.inner_cem`` once under
    every (selection, elite-carry) pair, whatever the kernel kind, with the
    pair ``selection_key`` resolves ("fused" always without elite-carry;
    "fused" and "g" become "xla" under another kernel than laplace, as in
    the JAX package), "g" with the coefficients, and returns its winner,
    which the pair's chain (``inner_cem_plain``) gives bit for bit."""
    cfg = _cfg(3, 2, kind)
    bc, M = cfg.beta_cem, cfg.risk.num_mother
    cx, cy, xr, yr = map(torch.from_numpy, _inputs(rng, M))
    calls = []

    def counted(*a, **kw):
        out = inner_cem(*a, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(reduced_set, "inner_cem", counted)
    tcfg = to_torch_cfg(cfg)
    for var in ("MPC_MMD_SELECTION", "MPC_MMD_FUSED_CEM"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", carry)
    draws = FixedNoise(jax_draws(cfg, 0), "cpu").inner_cem(
        bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    got = reduced_set.select_reduced_set_batched(tcfg, cx, cy, xr, yr, draws,
                                                 selection=selection)
    assert len(calls) == 1
    kw, (beta, sigma, idx, res) = calls[0]
    want = reduced_set.selection_key(tcfg, selection)
    assert (kw["selection"], kw["carry"]) == want
    assert want == ((selection if kind == "laplace" or selection in ("xla", "xt")
                     else "xla"), carry == "1" and want[0] != "fused")
    assert (kw["coeffs"] is not None) == (want[0] == "g")
    assert torch.equal(got.beta, beta) and torch.equal(got.sigma, sigma)
    assert torch.equal(got.res, res) and torch.equal(got.x_red, take_rows(xr, idx))
    inputs = reduced_set.inner_inputs(tcfg, cx, cy, draws)
    ref = inner_cem_plain(*inputs, 3, bc.num_ellite, bc.rho_beta, bc.qp_reg, kind,
                          selection=want[0], carry=want[1], coeffs=(cx, cy))
    for a, b in zip((beta, sigma, idx, res), ref):
        assert torch.equal(a, b)


# (selection, maxiter, edit): every selection at one and three iterations
# with each edit of the first batch, the infinite lane for "fused"
CARRY_CASES = [(sel, maxiter, edit) for sel in SELECTIONS for maxiter in (1, 3)
               for edit in (None, "nan_lane", "ties")] + [
    ("fused", 1, "inf_lane"), ("fused", 3, "inf_lane")]


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("selection,maxiter,edit", CARRY_CASES)
def test_chain_with_elite_carry_equals_chain_without(selection, k, maxiter, edit):
    """The argument kernel (c)'s forms rest on: a row's selection and
    weight QP are a function of the row and D alone in every selection's
    chain, so each chain with elite-carry (the elites' results carried)
    gives the chain without it (every row recomputed) bit for bit in every
    output, on the CPU at C 3, S 12 (n_el 3), M = k^2, with a NaN lane in
    row 1 of the first batch and tied |beta| in row 2, or an infinite lane
    in row 3 (which wins every round of "fused"'s top-k).  Its own
    generator draws the inputs."""
    gen = torch.Generator().manual_seed(1000 * k + 10 * maxiter + SELECTIONS.index(selection))
    inp, n_el, rho, reg, cfg, cx, cy = kc_inputs(gen, C, 12, k, maxiter,
                                                 inf_lane=edit == "inf_lane", full=True)
    s0 = inp.samples0_row
    if edit != "nan_lane":          # kc_inputs puts a NaN lane in row 1
        s0[1, 7 % (k * k)] = torch.randn((), generator=gen)
    if edit != "ties":              # and tied |beta| in row 2
        s0[2] = s0[2] + 0.5 * torch.rand(s0.shape[1], generator=gen)
    args = (*inp, k, n_el, rho, reg, "laplace")
    kw = dict(selection=selection, coeffs=(cx, cy))
    got = inner_cem_plain(*args, carry=True, **kw)
    ref = inner_cem_plain(*args, carry=False, **kw)
    for name, a, b in zip(("beta_w", "sigma_w", "idx_best", "res"), got, ref):
        assert bool(((a == b) | (a.isnan() & b.isnan())).all()), name
    assert bool(torch.isfinite(got[3]).all())
