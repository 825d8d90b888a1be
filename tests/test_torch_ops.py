"""K1, K2, K3 and K5 of the PyTorch port: plain twins vs the Pallas kernels.

The CUDA kernels cannot run here; on CPU tensors each wrapper takes its
plain twin, and these tests hold the twins to the JAX package's Pallas
kernels in interpret mode (the pattern of tests/test_ops.py) and to its
plain references.  Top-k indices and one-hot rows must be equal exactly;
the QP agrees at rtol 1e-4, the bound tests/test_ops.py uses for the
Pallas QP; the fused selection's row sums and K_red at rtol 1e-5 + atol
1e-5, the bound tests/test_ops.py holds that Pallas kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_mmd_tpu.linalg import eq_qp_solve as j_eq_qp_solve
from mpc_mmd_tpu.ops.qp_pallas import eq_qp_solve_pallas
from mpc_mmd_tpu.ops.topk_kernel_pallas import topk_kernel_matrices as j_fused
from mpc_mmd_tpu.ops.topk_pallas import topk_indices_pallas, topk_onehot_pallas
from mpc_mmd_tpu.reduced_set import _topk
from mpc_mmd_tpu_torch.ops import (eq_qp_solve, topk_indices,
                                   topk_kernel_matrices, topk_onehot)
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


def test_topk_twin_matches_pallas_on_elite_pick_edge_rows(rng):
    """The elite pick ranks -cost without `absolute`, so -0.0 and +0.0, and
    +-inf, reach the rounds as they are.  -0.0 ties +0.0 (the lowest index
    wins), +inf wins, -inf ranks with NaN, and once a row's finite lanes
    run out every later round emits index 0.  The CUDA kernel's order-key
    rounds keep exactly these rules."""
    k = 7
    x = -rng.normal(0, 1, (8, 64)).astype(np.float32)
    x[0] = 0.0
    x[0, ::2] = -0.0                          # ties across signed zeros
    x[1, [3, 20]] = np.inf
    x[1, 9] = -np.inf
    x[2, :60] = np.nan                        # 4 finite lanes, k = 7
    x[3] = -np.inf
    x[3, 10] = np.nan
    x[3, 40] = -0.0                           # one finite lane
    x[4] = np.round(x[4])
    x[4][x[4] == 0] = -0.0                    # -0.0 ties among rounded values
    x[4, 1::5] = 0.0
    x[5, :62] = -np.inf                       # 2 finite lanes
    got, ref = _topk_both(x, k)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], np.arange(k))
    np.testing.assert_array_equal(got[1, :2], [3, 20])
    assert set(got[2, :4]) == {60, 61, 62, 63} and not got[2, 4:].any()
    assert got[3, 0] == 40 and not got[3, 1:].any()
    assert set(got[5, :2]) == {62, 63} and not got[5, 2:].any()


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


def _selection_inputs(rng, C, S, M):
    """tests/test_ops.py's inputs, plus a NaN lane, tied |beta| and an
    infinite lane."""
    samples = rng.normal(0, 1, (C, S, M + 1)).astype(np.float32)
    samples[:, :, -1] = np.abs(samples[:, :, -1]) + 0.2
    samples[0, 1, 3] = np.nan
    samples[0, 2, :M] = np.round(samples[0, 2, :M])
    samples[-1, -1, 2] = np.inf
    D = np.abs(rng.normal(0, 1, (C, M, M))).astype(np.float32)
    return samples, D + np.swapaxes(D, 1, 2)


@pytest.mark.parametrize("C,S,M,k", [(2, 100, 9, 3), (1, 130, 25, 5)])
def test_fused_selection_twin_matches_pallas(rng, C, S, M, k):
    samples, D = _selection_inputs(rng, C, S, M)
    ref = j_fused(jnp.asarray(samples), jnp.asarray(D), k, interpret=True)
    before = topk_kernel_matrices.launches
    got = topk_kernel_matrices(torch.from_numpy(samples), torch.from_numpy(D), k)
    assert topk_kernel_matrices.launches == before
    assert got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # the Pallas kernel has no NaN mask: a NaN lane emits index M every
    # round, zero rows (row sum M) and a zero K_red; an infinite lane stays
    # infinite under the subtracted mask and wins every round
    np.testing.assert_array_equal(got[2][0, 1].numpy(), np.full(k, M))
    np.testing.assert_allclose(got[0][0, 1].numpy(), float(M))
    assert not got[1][0, 1].any()
    np.testing.assert_array_equal(got[2][-1, -1].numpy(), np.full(k, 2))


def test_fused_selection_wrapper_validates():
    s, D = torch.zeros(2, 4, 10), torch.zeros(2, 9, 9)
    with pytest.raises(ValueError):
        topk_kernel_matrices(s, D, 10)                   # k > M
    with pytest.raises(ValueError):
        topk_kernel_matrices(s, D[:, :8, :8], 3)         # D does not match
    with pytest.raises(ValueError):
        topk_kernel_matrices(s[0], D[0], 3)              # not batched
    # a batch shared by every candidate (stride 0) gives the copy's result
    shared = torch.randn(1, 4, 10).expand(2, 4, 10)
    for g, r in zip(topk_kernel_matrices(shared, D + 1.0, 3),
                    topk_kernel_matrices(shared.contiguous(), D + 1.0, 3)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("shape,k", [((40, 50, 64), 10), ((7, 33), 5)])
@pytest.mark.parametrize("absolute", [False, True])
def test_onehot_topk_twin_matches_pallas(rng, shape, k, absolute):
    x = rng.normal(0, 1, shape).astype(np.float32)
    x.reshape(-1, shape[-1])[0, ::3] = np.nan
    kw = dict(absolute=True, slice_to=shape[-1] - 1) if absolute else {}
    for xt in (x, np.round(x * 2) / 2):
        ref_i, ref_oh = topk_onehot_pallas(jnp.asarray(xt), k, interpret=True, **kw)
        before = topk_onehot.launches
        idx, oh = topk_onehot(torch.from_numpy(xt), k, **kw)
        assert topk_onehot.launches == before
        assert idx.dtype == torch.int32 and oh.dtype == torch.float32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(oh.numpy(), np.asarray(ref_oh))
        assert torch.equal(idx, topk_indices(torch.from_numpy(xt), k, **kw))


def test_kernel_ab_variants_apply_to_the_kernel_sources(tmp_path):
    """The A/B tool's variants are textual changes of csrc/topk.cu and
    csrc/eq_qp.cu: each must find its anchor and change the source."""
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.utils import kernel_ab
    for name in ("topk.cu", "eq_qp.cu"):
        (tmp_path / name).write_text((_build.CSRC / name).read_text())
    srcs = kernel_ab.builds(tmp_path, diagnose=True)
    assert srcs["k1_before"][1] == srcs["k1_now"][1]
    for name, (kind, src) in srcs.items():
        if name not in ("k1_now", "k2_now", "k1_before", "k2_before", "micro"):
            assert src != srcs[f"{kind}_now"][1], name


def test_solve_ab_checks_its_arguments_and_needs_a_card(tmp_path, monkeypatch):
    """The single-solve A/B tool refuses a root without chip_smoke.py and
    turns other than A and B, and without a card it stops before any
    turn; its worker is valid Python."""
    from mpc_mmd_tpu_torch.utils import solve_ab
    compile(solve_ab.WORKER, "solve_ab.WORKER", "exec")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="no chip_smoke.py"):
        solve_ab.main(["--before", str(tmp_path)])
    with pytest.raises(SystemExit, match="takes A and B"):
        solve_ab.main(["--before", str(tmp_path), "--turns", "ABC"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        solve_ab.main(["--before", str(tmp_path)])
