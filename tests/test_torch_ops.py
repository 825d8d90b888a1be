"""K1 and K2 of the PyTorch port: plain twins vs the Pallas kernels.

The CUDA kernels cannot run here; on CPU tensors each wrapper takes its
plain twin, and these tests hold the twins to the JAX package's Pallas
kernels in interpret mode (the pattern of tests/test_ops.py) and to its
plain references.  Top-k indices must be equal exactly; the QP agrees at
rtol 1e-4, the bound tests/test_ops.py uses for the Pallas QP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu.linalg import eq_qp_solve as j_eq_qp_solve
from mpc_mmd_tpu.ops.qp_pallas import eq_qp_solve_pallas
from mpc_mmd_tpu.ops.topk_pallas import topk_indices_pallas
from mpc_mmd_tpu.reduced_set import _topk
from mpc_mmd_tpu_torch.ops import eq_qp_solve, topk_indices
from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain

torch.set_num_threads(1)


def _topk_both(x, k, **kw):
    ref = np.asarray(topk_indices_pallas(jnp.asarray(x), k, interpret=True, **kw))
    before = topk_indices.launches
    got = topk_indices(torch.from_numpy(x), k, **kw)
    assert topk_indices.launches == before      # CPU tensors take the twin
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    return got.numpy(), ref


@pytest.mark.parametrize("shape,k,kw", [
    ((64, 101), 10, dict(absolute=True, slice_to=100)),   # selection rows
    ((3, 16, 17), 4, dict(absolute=True, slice_to=16)),
    ((4, 64), 7, {}),                                     # elite pick
    ((7, 33), 5, {}),
    ((2, 5, 40), 40, {}),                                 # k == width
])
def test_topk_twin_matches_pallas(rng, shape, k, kw):
    x = rng.normal(0, 1, shape).astype(np.float32)
    got, ref = _topk_both(x, k, **kw)
    np.testing.assert_array_equal(got, ref)
    if not kw:
        np.testing.assert_array_equal(got, np.asarray(jax.lax.top_k(x, k)[1]))
    # ties: values rounded to halves; the lowest index wins (lax.top_k is
    # not the reference here: it orders -0.0 below +0.0, max-and-mask
    # rounds treat them as equal)
    xt = np.round(x * 2) / 2
    got, ref = _topk_both(xt, k, **kw)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("absolute", [False, True])
def test_topk_twin_nan_lanes_rank_last(rng, absolute):
    M, k = 33, 5
    x = rng.normal(0, 1, (9, M)).astype(np.float32)
    x[0, :] = np.nan                      # all-NaN row: index 0, k times
    x[1, ::2] = np.nan
    x[2, x[2] > 0] = np.nan
    x[3, :M - 2] = np.nan                 # fewer finite lanes than k
    got, ref = _topk_both(x, k, absolute=absolute)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], np.zeros(k, np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(_topk(jnp.asarray(x), k, absolute=absolute)))


def test_topk_wrapper_validates():
    x = torch.zeros(3, 10)
    with pytest.raises(ValueError):
        topk_indices(x, 2, slice_to=11)
    with pytest.raises(ValueError):
        topk_indices(x, 0)
    assert torch.equal(topk_indices(x, 2), topk_indices_plain(x, 2))


def _spd(rng, batch, n):
    A = rng.normal(0, 1, batch + (n, n))
    C = np.einsum("...ij,...kj->...ik", A, A) + 2.0 * np.eye(n)
    return C.astype(np.float32), rng.normal(0, 1, batch + (n,)).astype(np.float32)


def _beta_qp_systems(rng, batch, n):
    """Systems as the inner CEM builds them: rho K + reg I with K a Laplace
    kernel matrix of random features (rho = 1, reg = 0.05)."""
    f = rng.normal(0, 1, batch + (n, 22))
    d = np.abs(f[..., :, None, :] - f[..., None, :, :]).sum(-1)
    sigma = np.abs(rng.normal(0, 4.5, batch))[..., None, None] + 0.01
    K = np.exp(-d / sigma)
    C = K + 0.05 * np.eye(n)
    r = K.sum(-1) / 100.0
    return C.astype(np.float32), r.astype(np.float32)


@pytest.mark.parametrize("n", [4, 10])
@pytest.mark.parametrize("build", [_spd, _beta_qp_systems])
def test_eq_qp_twin_matches_pallas_and_linalg(rng, n, build):
    C, r = build(rng, (3, 19), n)
    jb1, jmu1 = eq_qp_solve_pallas(jnp.asarray(C), jnp.asarray(r), interpret=True)
    jb2, jmu2 = j_eq_qp_solve(jnp.asarray(C), jnp.asarray(r))
    before = eq_qp_solve.launches
    b, mu = eq_qp_solve(torch.from_numpy(C), torch.from_numpy(r))
    assert eq_qp_solve.launches == before
    assert b.shape == (3, 19, n) and mu.shape == (3, 19)
    for jb, jmu in ((jb1, jmu1), (jb2, jmu2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.sum(-1).numpy(), 1.0, atol=1e-4)


def test_eq_qp_twin_matches_float64_solve(rng):
    """The block elimination solves the KKT system [[C, 1], [1^T, 0]]."""
    C, r = _beta_qp_systems(rng, (50,), 10)
    b, mu = eq_qp_solve(torch.from_numpy(C).double(), torch.from_numpy(r).double())
    kkt = np.zeros((50, 11, 11))
    kkt[:, :10, :10] = C
    kkt[:, :10, 10] = 1.0
    kkt[:, 10, :10] = 1.0
    rhs = np.concatenate((r, np.ones((50, 1))), axis=1)
    sol = np.linalg.solve(kkt, rhs[..., None])[..., 0]
    np.testing.assert_allclose(b.numpy(), sol[:, :10], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(mu.numpy(), sol[:, 10], rtol=1e-9, atol=1e-9)


def test_eq_qp_wrapper_validates():
    with pytest.raises(ValueError):
        eq_qp_solve(torch.eye(3)[None], torch.zeros(1, 4))
