"""The port's CUDA kernels against their plain twins, on a CUDA card.

Marked ``gpu``: without a card every test here skips.  On a machine with
one, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX).  This file
imports no JAX.  Tolerances: top-k indices and one-hot rows exact; QP
within rtol 1e-4 + atol 1e-5 of the twin in float64; rollout within atol
1e-4 of the twin on the card (accurate tanf/sinf/cosf, FMA contraction);
the fused selection's indices and K_red exact (the kernel and the twin on
the card take the same IEEE quotient and expf), its row sums within rtol
1e-5 + atol 1e-6 (sums taken in another order); kernel (c) at one
iteration: the winner's indices exact, its weights, bandwidth and costs
within rtol 1e-5 + atol 1e-6; over every iteration the costs within rtol
1e-4 + atol 1e-6 for all but 2 % of the candidates (near-ties that the
resample's round-off may decide; on the H100 every output has been
bit-equal), and each of its other forms ("fused", "xt", "g", without
elite-carry) bit-equal to its chain; kernels (d) and (e): every output within rtol 1e-5 + atol 1e-6
of the plain version on the card, (e)'s kept, elites and pick exact; at
the path shapes every output bit-equal to the plain version, (d) at each
launch choice (rows a CTA, compile-time or run-time shape) and (e) at
every cluster size, whose CTAs keep the same candidates; (d)'s run-time
shape at num 60 within rtol 1e-5 + atol 1e-6; K4n and kernels (f) and (g)
bit-equal to their plain versions on the card at two path shapes each, K4n
and (f) also at their edges (run-time T, Beta draws with a state per lane,
F15, 11a's chunk of 32; (f) at every cluster size, D and D2 symmetric), (g)
also on its adversarial inputs and a closed-loop frame (its indices and
visited tiles its twin's), and (g)'s state and obstacle forms bit-equal to
their chains (the obstacle form's constant-velocity trajectories too);
kernel (h) bit-equal to its chain (the smoother and the path parameters)
and to its twin, on windows of three routes at two widths and one and ten
rounds, at widths from 64 to 639 path points, NaN to NaN, its phase-clock
build too; kernel (a)'s plan form bit-equal to per-segment ``prng_draws``
at the solves' plans, and a graphed solve of each path one plan launch and
no ``prng_draws`` launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_mmd_tpu_torch import Solver, dynamic_workload, fastrt_workload
from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
from mpc_mmd_tpu_torch.linalg import scenario_mm
from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, record_solve_draws
from mpc_mmd_tpu_torch.ops import (eq_qp_solve, eq_qp_solve_t, fused_rollout,
                                   inner_cem, noisy_rollout, topk_indices,
                                   topk_kernel_matrices, topk_onehot)
from mpc_mmd_tpu_torch.ops.inner_cem import inner_cem_plain
from mpc_mmd_tpu_torch.ops.qp import eq_qp_solve_t_plain
from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain, topk_onehot_plain
from mpc_mmd_tpu_torch.ops.topk_kernel import topk_kernel_matrices_plain
from mpc_mmd_tpu_torch.sampling import _cholesky
from mpc_mmd_tpu_torch.utils import chunk_bits
from mpc_mmd_tpu_torch.utils.kernel_ab import (KG_CASES, KH_AT, KH_ROUNDS, KH_ROUTES, KH_WIDTHS,
                                               kh_window)

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _edge_rows(x, k):
    """x (..., w) with, in as many leading rows as it has: all NaN, NaN
    lanes, ties, -0.0 against +0.0, +-inf, fewer finite lanes than k."""
    flat = x.view(-1, x.shape[-1])
    w = x.shape[-1]
    edits = [lambda r: r.fill_(float("nan")),
             lambda r: r[::3].fill_(float("nan")),
             lambda r: r.copy_(torch.round(r * 2) / 2),
             lambda r: (r.fill_(0.0), r[::2].fill_(-0.0)),
             lambda r: (r[5 % w].fill_(float("inf")), r[7 % w].fill_(-float("inf"))),
             lambda r: r[:max(1, w - k + 2)].fill_(float("nan"))]
    for row, edit in zip(flat, edits):
        edit(row)
    return x


@pytest.mark.parametrize("shape,k,kw", [
    ((64, 57, 101), 10, dict(absolute=True, slice_to=100)),
    ((5, 128), 20, {}),
    ((3, 7, 33), 33, dict(absolute=True)),
    ((64, 64), 7, {}),                                         # fastrt elites
    ((1, 1, 3), 5, {}),                                        # k > width
    ((1, 101), 10, dict(absolute=True, slice_to=100)),
    ((33, 101), 10, dict(absolute=True, slice_to=100)),
    ((3649, 101), 10, dict(absolute=True, slice_to=100)),
    ((100, 89, 101), 10, dict(absolute=True, slice_to=100)),   # Path A, "xla"
    ((1, 100, 101), 10, dict(absolute=True, slice_to=100)),    # its iteration 0
    ((100, 100), 11, {}),                                      # Path A elites
    ((6, 70), 40, {}),                                         # k > 32
    ((8900, 101), 10, dict(absolute=True, slice_to=100)),      # two rows a warp
    ((100, 89, 17), 4, dict(absolute=True, slice_to=16)),      # on-road, "xla"
    ((1, 100, 17), 4, dict(absolute=True, slice_to=16)),       # its iteration 0
    ((256, 57, 101), 10, dict(absolute=True, slice_to=100)),   # fastrt chunk of 4
    ((512, 57, 101), 10, dict(absolute=True, slice_to=100)),   # fastrt chunk of 8
    ((256, 64), 7, {}), ((512, 64), 7, {}),                    # their elite picks
    ((400, 100), 11, {}),                                      # Path A chunk of 4
])
def test_topk_kernel_matches_twin(cuda, shape, k, kw):
    """K1 at the path shapes and at row counts off its rows per block, with
    NaN, ties, -0.0/+0.0, +-inf (without `absolute` too) and rows with
    fewer finite lanes than k: equal to the twin exactly."""
    x = _edge_rows(torch.randn(shape, device="cuda", generator=cuda), k)
    x.view(-1, shape[-1])[-1, ::2] = float("nan")
    for t in (x, -x, torch.round(x * 2) / 2):
        before = topk_indices.launches
        got = topk_indices(t, k, **kw)
        assert topk_indices.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, topk_indices_plain(t, k, **kw))
    if got.numel() > 4 * k and k <= shape[-1]:  # the -0.0/+0.0 row ties everywhere
        assert torch.equal(got.view(-1, k)[3].long(), torch.arange(k, device="cuda"))


def test_topk_kernel_on_a_view_at_an_odd_row_offset(cuda):
    """A contiguous view that starts one 101-float row in: not 16-byte
    aligned."""
    x = _edge_rows(torch.randn(3650, 101, device="cuda", generator=cuda), 10)
    for v, k, kw in ((x[1:], 10, dict(absolute=True, slice_to=100)),
                     (x[1:].view(-1)[:64 * 64].view(64, 64), 7, {})):
        assert v.is_contiguous() and v.data_ptr() % 16 != 0
        assert torch.equal(topk_indices(v, k, **kw), topk_indices_plain(v, k, **kw))


def _qp_systems(gen, batch, n):
    """``batch`` (a shape) systems as the inner CEM builds them."""
    f = torch.randn(batch + (n, 22), device="cuda", generator=gen)
    d = (f[..., :, None, :] - f[..., None, :, :]).abs().sum(-1)
    sigma = torch.rand(batch + (1, 1), device="cuda", generator=gen) * 10 + 0.01
    K = torch.exp(-d / sigma)
    C = (K + 0.05 * torch.eye(n, device="cuda")).contiguous()
    return C, (K.sum(-1) / 100.0).contiguous()


def _shifted(t, floats):
    """A contiguous copy of t that starts ``floats`` floats into a buffer."""
    buf = torch.empty(t.numel() + floats, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("n", [4, 10])
def test_eq_qp_kernel_on_views_at_an_odd_system_offset(cuda, n):
    """C and r one system in (r's span then starts 40 bytes in for n = 10),
    and both one float in: spans that are not 16-byte aligned, which the
    kernel copies 4 bytes at a time.  The result is that of the aligned
    copies, bit for bit."""
    C, r = _qp_systems(cuda, (101,), n)
    bc, muc = eq_qp_solve(C[1:].clone(), r[1:].clone())
    for Cv, rv in ((C[1:], r[1:]), (_shifted(C[1:], 1), _shifted(r[1:], 1))):
        assert Cv.is_contiguous() and rv.is_contiguous()
        b, mu = eq_qp_solve(Cv, rv)
        assert torch.equal(b, bc) and torch.equal(mu, muc)
    b64, mu64 = qp_plain(C[1:].double(), r[1:].double())
    torch.testing.assert_close(b.double(), b64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [4, 10])
@pytest.mark.parametrize("batch", [(64, 57), (1,), (31,), (33,), (3648,), (8900,),
                                   (10000,), (10001,),
                                   # fastrt chunks of 4 and 8, Path A's of 4
                                   (14592,), (16384,), (29184,), (32768,),
                                   (40000,)])
def test_eq_qp_kernel_matches_float64_twin(cuda, n, batch):
    """K2 at the paths' sizes (n = 4 on the on-road path) and at batches off
    its 64 systems a block."""
    C, r = _qp_systems(cuda, batch, n)
    before = eq_qp_solve.launches
    b, mu = eq_qp_solve(C, r)
    assert eq_qp_solve.launches == before + 1
    b64, mu64 = qp_plain(C.double(), r.double())
    torch.testing.assert_close(b.double(), b64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [4, 10])
@pytest.mark.parametrize("batch", [1, 31, 33, 3648, 4096, 8900, 10000, 10001])
def test_lane_major_eq_qp_kernel_matches_twin_and_k2(cuda, n, batch):
    """K2's lane-major entry (the "xt" selection's) at the paths' sizes and
    off its 64 systems a block: within rtol 1e-4 + atol 1e-5 of the twin
    in float64, and bit-equal to K2's row-major kernel on the same systems
    (one body)."""
    C, r = _qp_systems(cuda, (batch,), n)
    C_t, r_t = C.reshape(batch, n * n).T.contiguous(), r.T.contiguous()
    before = eq_qp_solve_t.launches
    b_t, mu = eq_qp_solve_t(C_t, r_t)
    assert eq_qp_solve_t.launches == before + 1 and b_t.shape == (n, batch)
    b64, mu64 = eq_qp_solve_t_plain(C_t.double(), r_t.double())
    torch.testing.assert_close(b_t.double(), b64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)
    b, mu_rm = eq_qp_solve(C, r)
    assert torch.equal(b_t, b.T) and torch.equal(mu, mu_rm)


@pytest.mark.parametrize("T", [1, 37, 50])
@pytest.mark.parametrize("lanes", [1, 400, 1000, 1600, 4000, 6401, 25_600, 40_000,
                                   51_200, 255_999])
@pytest.mark.parametrize("per_lane", [False, True])
def test_rollout_kernel_matches_twin(cuda, lanes, T, per_lane):
    """K4 at lane counts that are not multiples of its 32-lane block and
    at several horizons, with a shared (stride 0) and a per-lane (stride 5)
    state (1,600 lanes: the on-road mmd_opt solve's)."""
    acc = 1.0 + 0.5 * torch.randn(lanes, T, device="cuda", generator=cuda)
    steer = 0.1 * torch.randn(lanes, T, device="cuda", generator=cuda)
    s0 = (torch.randn(lanes, 5, device="cuda", generator=cuda) if per_lane
          else torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device="cuda"))
    before = fused_rollout.launches
    x, y = fused_rollout(acc, steer, s0, 0.15, 2.5)
    assert fused_rollout.launches == before + 1
    xr, yr = rollout_plain(acc, steer, s0, 0.15, 2.5)
    torch.testing.assert_close(x, xr, rtol=0, atol=1e-4)
    torch.testing.assert_close(y, yr, rtol=0, atol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.randn(4, 257, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="256"):
        topk_indices(x, 3)                                 # wider than 256
    with pytest.raises(ValueError, match="256"):
        topk_onehot(x, 3)
    with pytest.raises(ValueError):
        topk_indices(x[:, :100].t(), 3)                    # not contiguous
    with pytest.raises(TypeError):
        topk_indices(x.double(), 3)
    C = torch.eye(17, device="cuda").expand(3, 17, 17).contiguous()
    with pytest.raises(ValueError, match="2 ... 16"):
        eq_qp_solve(C, torch.ones(3, 17, device="cuda"))   # n past 16
    with pytest.raises(ValueError, match="2 ... 16"):
        eq_qp_solve(C[:, :1, :1].contiguous(), torch.ones(3, 1, device="cuda"))
    with pytest.raises(ValueError):
        eq_qp_solve(C[:, :4, :4].contiguous(), torch.ones(3, 4))   # mixed devices
    with pytest.raises(ValueError, match="2 ... 16"):
        eq_qp_solve_t(torch.ones(289, 3, device="cuda"),
                      torch.ones(17, 3, device="cuda"))    # n past 16
    with pytest.raises(ValueError):
        eq_qp_solve_t(torch.ones(16, 3, device="cuda").T.contiguous().T,
                      torch.ones(4, 3, device="cuda"))     # not contiguous


# kernel (c)'s path shapes (C, S, k, maxiter, kernel kind): fastrt, its
# chunks of 4, 8 and 32 scenarios, Path A "xla", Path D, Path F at N = 5
# and 15, fastrt with the gaussian and matern52 kernels
INNER_CEM_SHAPES = [(64, 64, 10, 12, "laplace"), (256, 64, 10, 12, "laplace"),
                    (512, 64, 10, 12, "laplace"), (2048, 64, 10, 12, "laplace"),
                    (100, 100, 10, 20, "laplace"), (100, 100, 4, 20, "laplace"),
                    (100, 100, 5, 20, "laplace"), (100, 100, 15, 20, "laplace"),
                    (64, 64, 10, 12, "gaussian"), (64, 64, 10, 12, "matern52")]


@pytest.mark.parametrize("C,S,k,maxiter,kind", INNER_CEM_SHAPES)
def test_inner_cem_kernel_matches_its_plain_version(cuda, C, S, k, maxiter, kind):
    from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
    for iters in (1, maxiter):
        inp, n_el, rho, reg = kc_inputs(cuda, C, S, k, iters, kind)
        args = (*inp, k, n_el, rho, reg, kind)
        before = inner_cem.launches
        got = inner_cem(*args)
        assert inner_cem.launches == before + 1
        ref = inner_cem_plain(*args)
        torch.cuda.synchronize()
        for g in (got[0], got[1], got[3]):
            assert bool(torch.isfinite(g).all())
        if iters == 1:
            assert torch.equal(got[2], ref[2])
            for g, r in ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])):
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        else:
            apart = ((got[3] - ref[3]).abs() > 1e-4 * ref[3].abs() + 1e-6).any(dim=1)
            assert int(apart.sum()) <= 0.02 * C


# the edges of kernel (c)'s split of a candidate over a cluster (C, S, k,
# kind): one candidate, candidate counts past a wave of 64 and of 132
# clusters, M = 144 (the vectorised row sum) and M = 256 at S = 256, the
# gaussian kernel, and S = 33 (S' = 29 fresh rows: not a multiple of a
# cluster's CTAs times 8 warps)
INNER_CEM_EDGES = [(1, 64, 10, "laplace"), (65, 64, 10, "laplace"),
                   (133, 64, 10, "laplace"), (100, 100, 12, "laplace"),
                   (64, 256, 16, "laplace"), (64, 64, 10, "gaussian"),
                   (64, 33, 10, "laplace")]


@pytest.mark.parametrize("C,S,k,kind", INNER_CEM_EDGES)
def test_inner_cem_kernel_at_the_edges_of_its_split(cuda, C, S, k, kind):
    from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
    for iters in (1, 4):
        inp, n_el, rho, reg = kc_inputs(cuda, C, S, k, iters, kind)
        args = (*inp, k, n_el, rho, reg, kind)
        before = inner_cem.launches
        got = inner_cem(*args)
        assert inner_cem.launches == before + 1
        ref = inner_cem_plain(*args)
        torch.cuda.synchronize()
        for g in (got[0], got[1], got[3]):
            assert bool(torch.isfinite(g).all())
        if iters == 1:
            assert torch.equal(got[2], ref[2])
            for g, r in ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])):
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        else:
            apart = ((got[3] - ref[3]).abs() > 1e-4 * ref[3].abs() + 1e-6).any(dim=1)
            assert int(apart.sum()) <= 0.02 * C


# kernel (c)'s forms (C, S, k, maxiter, selection, elite-carry), laplace:
# each at the path shapes that run it (fastrt "xt", "g" and "xla" without
# elite-carry; Path A and D and F5 / F15 fused, Path A's chunk of 4 fused;
# Path A, D, F5 and F15 "xt" and "g"), "xla" and "xt" without elite-carry at
# F15 and M = 169 (their elites run again: a row's sums move with its
# place), and the edges of the split: one candidate, S = 33, M = 144 at S =
# 256
INNER_CEM_FORMS = [(64, 64, 10, 12, "xt", True), (64, 64, 10, 12, "g", True),
                   (64, 64, 10, 12, "xla", False), (100, 100, 10, 20, "fused", False),
                   (100, 100, 10, 20, "xt", True), (100, 100, 10, 20, "g", True),
                   (400, 100, 10, 20, "fused", False), (100, 100, 4, 20, "fused", False),
                   (100, 100, 4, 20, "xt", True), (100, 100, 4, 20, "g", True),
                   (100, 100, 5, 20, "fused", False), (100, 100, 5, 20, "xt", True),
                   (100, 100, 15, 20, "fused", False), (100, 100, 15, 20, "xt", True),
                   (100, 100, 15, 20, "g", True), (100, 100, 15, 20, "xla", False),
                   (100, 100, 13, 6, "xt", False), (1, 64, 10, 4, "fused", False),
                   (64, 33, 10, 4, "g", False), (64, 256, 12, 4, "fused", False)]


@pytest.mark.parametrize("C,S,k,maxiter,selection,carry", INNER_CEM_FORMS)
def test_inner_cem_form_is_bit_equal_to_its_chain(cuda, C, S, k, maxiter, selection,
                                                  carry):
    """Each form against its (selection, elite-carry) pair's chain
    (``inner_cem_plain``: K1, K2, K2t, K3 and PyTorch's operations on the
    card) bit for bit in every output, NaN to NaN, with a NaN lane, tied
    |beta| and for "fused" an infinite lane in the first batch; one launch,
    counted by the wrapper and by the form's own count."""
    from mpc_mmd_tpu_torch.ops.inner_cem import FORMS
    from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
    for iters in (1, maxiter):
        inp, n_el, rho, reg, _, cx, cy = kc_inputs(
            cuda, C, S, k, iters, inf_lane=selection == "fused", full=True)
        args = (*inp, k, n_el, rho, reg, "laplace")
        form = dict(selection=selection, carry=carry, coeffs=(cx, cy))
        own = FORMS.get(selection, inner_cem)
        before = (inner_cem.launches, own.launches)
        got = inner_cem(*args, **form)
        assert (inner_cem.launches, own.launches) == (before[0] + 1, before[1] + 1)
        ref = inner_cem_plain(*args, **form)
        torch.cuda.synchronize()
        for name, g, r in zip(("beta_w", "sigma_w", "idx_best", "res"), got, ref):
            assert bool(((g == r) | (g.isnan() & r.isnan())).all()), (name, iters)


def test_inner_cem_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
    inp, n_el, rho, reg = kc_inputs(cuda, 2, 16, 4, 2)
    D, D2, s0, A, Z, floor = inp
    good = dict(D=D, D2=D2, samples0_row=s0, A_all=A, Zf_all=Z, lane_floor=floor,
                k=4, n_el=n_el, rho=rho, reg=reg, kind="laplace")
    with pytest.raises(ValueError, match="2 ... 16"):
        inner_cem(**dict(good, k=1))                       # k below 2
    with pytest.raises(TypeError):
        inner_cem(**dict(good, D=D.double()))
    with pytest.raises(ValueError):
        inner_cem(**dict(good, D=D.transpose(1, 2)))       # not contiguous
    with pytest.raises(ValueError):
        inner_cem(**dict(good, lane_floor=floor.cpu()))    # mixed devices
    big, n_big, _, _ = kc_inputs(cuda, 1, 272, 4, 1)       # S past 256
    with pytest.raises(ValueError, match="S <= 256"):
        inner_cem(*big, 4, n_big, rho, reg, "laplace")
    wide, n_w, _, _ = kc_inputs(cuda, 1, 16, 17, 1)        # k past 16, M past 256
    with pytest.raises(ValueError, match="2 ... 16"):
        inner_cem(*wide, 17, n_w, rho, reg, "laplace")


def _selection_inputs(gen, C, S, M):
    samples = torch.randn(C, S, M + 1, device="cuda", generator=gen)
    samples[..., M] = samples[..., M].abs() * 3 + 0.01
    samples[0, 1, 7 % M] = float("nan")                  # NaN lane: index M
    samples[0, 2, :M] = torch.round(samples[0, 2, :M])   # tied |beta|
    samples[-1, -1, 3] = float("inf")                    # wins every round
    f = torch.randn(C, M, 22, device="cuda", generator=gen)
    D = (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1).contiguous()
    return samples, D


@pytest.mark.parametrize("C,S,M,k", [
    (100, 100, 100, 10), (64, 64, 100, 10), (3, 37, 128, 32), (2, 5, 9, 3),
    (1, 33, 37, 1),      # one candidate, S past one block's 32 rows, k = 1
    (1, 100, 128, 32),   # the widest rows and the most rounds
    (5, 7, 37, 32),      # fewer rows than a block's warps, k = 32 of 37
    (4, 65, 128, 1),
    (6, 97, 100, 17),
    (100, 100, 16, 4),   # the on-road fused selection
    (400, 100, 100, 10), # Path A's fused selection, a chunk of 4 scenarios
])
def test_fused_selection_kernel_matches_twin(cuda, C, S, M, k):
    """K3 against its twin, NaN, tied and infinite rows included, at shapes
    that do and do not fill its blocks.  K_red is bit-equal to the twin's
    on the card: both take the IEEE quotient and expf of the same operands
    (only the row sums add in another order)."""
    samples, D = _selection_inputs(cuda, C, S, M)
    before = topk_kernel_matrices.launches
    got = topk_kernel_matrices(samples, D, k)
    assert topk_kernel_matrices.launches == before + 1
    ref = topk_kernel_matrices_plain(samples, D, k)
    assert got[2].dtype == torch.int32
    assert torch.equal(got[2], ref[2])
    assert bool((got[2][0, 1] == M).all())
    for g, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], ref[1])
    # one batch shared by every candidate: a candidate stride of 0
    shared = samples[:1].expand(C, S, M + 1)
    got0 = topk_kernel_matrices(shared, D, k)
    ref0 = topk_kernel_matrices(shared.contiguous(), D, k)
    for g, r in zip(got0, ref0):
        assert torch.equal(g, r)


def test_fused_selection_kernel_divides_exactly_out_of_range(cuda):
    """Rows whose sigma, and a candidate whose D, leave the range where the
    kernel's division takes its fast path divide with / : K_red stays
    bit-equal to the twin's there too."""
    C, S, M, k = 3, 40, 100, 10
    samples, D = _selection_inputs(cuda, C, S, M)
    samples[1, :5, M] = 1e-25       # a quotient past 2^60
    samples[1, 5:10, M] = 1e25      # a divisor past 2^60
    D[2, 3, 7] = 1e30               # one candidate's D out of range
    got = topk_kernel_matrices(samples, D, k)
    ref = topk_kernel_matrices_plain(samples, D, k)
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)


def test_fused_selection_wrapper_refuses(cuda):
    samples = torch.randn(4, 8, 258, device="cuda", generator=cuda)
    D = torch.rand(4, 257, 257, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="256"):
        topk_kernel_matrices(samples, D, 5)                 # M > 256
    s = samples[..., :11].contiguous()
    d = D[:, :10, :10].contiguous()
    with pytest.raises(ValueError):
        topk_kernel_matrices(s.transpose(0, 1).contiguous().transpose(0, 1), d, 3)
    with pytest.raises(ValueError):
        topk_kernel_matrices(s, d.cpu(), 3)                 # mixed devices


@pytest.mark.parametrize("shape,k,kw", [
    ((64, 57, 101), 10, dict(absolute=True, slice_to=100)),
    ((40, 50, 64), 10, {}),
    ((7, 33), 5, {}),
])
def test_onehot_topk_kernel_matches_twin(cuda, shape, k, kw):
    x = torch.randn(shape, device="cuda", generator=cuda)
    x.view(-1, shape[-1])[0] = float("nan")
    x.view(-1, shape[-1])[-1, ::2] = float("nan")
    for t in (x, torch.round(x * 2) / 2):
        before = topk_onehot.launches
        idx, oh = topk_onehot(t, k, **kw)
        assert topk_onehot.launches == before + 1
        ridx, roh = topk_onehot_plain(t, k, **kw)
        assert torch.equal(idx, ridx) and torch.equal(oh, roh)
        assert torch.equal(idx, topk_indices(t, k, **kw))


REDUCED_SET_SIZES = range(2, 17)   # N = num_reduced; M = N^2 mother rollouts


def test_sizes_that_were_refused_now_launch(cuda):
    """K2 at n = 5 and K1 over 225 lanes (the record's N = 5 and N = 15
    cells): both launch their kernel and agree with their twins, where the
    wrappers once raised."""
    C, r = _qp_systems(cuda, (8900,), 5)
    before = eq_qp_solve.launches
    b, mu = eq_qp_solve(C, r)
    assert eq_qp_solve.launches == before + 1
    b64, mu64 = qp_plain(C.double(), r.double())
    torch.testing.assert_close(b.double(), b64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)
    x = _edge_rows(torch.randn(100, 89, 226, device="cuda", generator=cuda), 15)
    before = topk_indices.launches
    got = topk_indices(x, 15, absolute=True, slice_to=225)
    assert topk_indices.launches == before + 1
    assert torch.equal(got, topk_indices_plain(x, 15, absolute=True, slice_to=225))


@pytest.mark.parametrize("N", REDUCED_SET_SIZES)
def test_topk_kernels_match_twins_at_every_reduced_set_size(cuda, N):
    """K1 at the inner CEM's shapes for num_reduced N (the fresh rows
    (100, 89, N^2 + 1) and the iteration-0 batch (1, 100, N^2 + 1), k = N,
    |x| of the first N^2 lanes), edge rows included, and K5 on the fresh
    rows: indices and one-hot rows equal to the twins exactly."""
    M = N * N
    kw = dict(absolute=True, slice_to=M)
    for shape in ((100, 89, M + 1), (1, 100, M + 1)):
        x = _edge_rows(torch.randn(shape, device="cuda", generator=cuda), N)
        for t in (x, torch.round(x * 2) / 2):
            before = topk_indices.launches
            got = topk_indices(t, N, **kw)
            assert topk_indices.launches == before + 1
            assert torch.equal(got, topk_indices_plain(t, N, **kw))
    before = topk_onehot.launches
    idx, oh = topk_onehot(x, N, **kw)
    assert topk_onehot.launches == before + 1
    ridx, roh = topk_onehot_plain(x, N, **kw)
    assert torch.equal(idx, ridx) and torch.equal(oh, roh)


@pytest.mark.parametrize("N", REDUCED_SET_SIZES)
def test_eq_qp_kernels_match_twins_at_every_reduced_set_size(cuda, N):
    """K2 and its lane-major entry at n = N on the inner CEM's 8,900 and
    10,000 systems (and 33, off a block): within rtol 1e-4 + atol 1e-5 of
    the twin in float64 (the bound of the n = 4 and 10 cases: C = K + 0.05 I
    with K a Laplace kernel matrix, positive definite with row sums at most
    n, so cond(C) <= (n + 0.05) / 0.05 <= 321), and the lane-major entry
    bit-equal to K2."""
    for batch in (33, 8900, 10000):
        C, r = _qp_systems(cuda, (batch,), N)
        before = (eq_qp_solve.launches, eq_qp_solve_t.launches)
        b, mu = eq_qp_solve(C, r)
        b_t, mu_t = eq_qp_solve_t(C.reshape(batch, N * N).T.contiguous(), r.T.contiguous())
        assert (eq_qp_solve.launches, eq_qp_solve_t.launches) == (before[0] + 1,
                                                                   before[1] + 1)
        b64, mu64 = qp_plain(C.double(), r.double())
        torch.testing.assert_close(b.double(), b64, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)
        assert torch.equal(b_t, b.T) and torch.equal(mu_t, mu)
    # a view one system in: spans that are not 16-byte aligned
    bv, muv = eq_qp_solve(C[1:], r[1:])
    bc, muc = eq_qp_solve(C[1:].clone(), r[1:].clone())
    assert torch.equal(bv, bc) and torch.equal(muv, muc)


@pytest.mark.parametrize("N", REDUCED_SET_SIZES)
def test_fused_selection_kernel_matches_twin_at_every_reduced_set_size(cuda, N):
    """K3 at the static workload's fused selection for num_reduced N,
    (100, 100, N^2 + 1) with k = N, NaN, tied and infinite rows included:
    indices and K_red equal to the twin, row sums within rtol 1e-5 + atol
    1e-6; and with one batch shared by every candidate (stride 0)."""
    M = N * N
    samples, D = _selection_inputs(cuda, 100, 100, M)
    before = topk_kernel_matrices.launches
    got = topk_kernel_matrices(samples, D, N)
    assert topk_kernel_matrices.launches == before + 1
    ref = topk_kernel_matrices_plain(samples, D, N)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    shared = samples[:1].expand(100, 100, M + 1)
    for g, r in zip(topk_kernel_matrices(shared, D, N),
                    topk_kernel_matrices(shared.contiguous(), D, N)):
        assert torch.equal(g, r)


def test_fused_selection_kernel_divides_exactly_out_of_range_from_device_memory(cuda):
    """Past the staged widths K3 reads D's selected rows from device memory
    and checks each row's range as it reads it: out-of-range rows and sigmas
    still divide with / and K_red stays bit-equal to the twin's."""
    C, S, M, k = 3, 40, 225, 15
    samples, D = _selection_inputs(cuda, C, S, M)
    samples[1, :5, M] = 1e-25
    samples[1, 5:10, M] = 1e25
    D[2, :, 7] = 1e30
    got = topk_kernel_matrices(samples, D, k)
    ref = topk_kernel_matrices_plain(samples, D, k)
    assert torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N", [5, 15])
@pytest.mark.parametrize("selection", ["xla", "fused", "xt"])
def test_record_cell_outer_iteration_cuda_matches_cpu(cuda, monkeypatch, N, selection):
    """One outer iteration of static mmd_opt with Beta noise 0.3 at the
    record's N = 5 and N = 15 (M = 25 and 225 mother rollouts), at a cut
    budget (16 candidates, inner CEM 16 x 4), on the card against the CPU
    on the same draws (the CPU run records its Beta draws):

    - the returned candidate's coefficients within the bounds of the N = 4
      cases above;
    - the inner CEM on the card, given the CPU run's own inputs (mother
      rollouts, their refits and the inner draws), selects the same rollouts
      and gives beta and sigma within 1e-5 and the residuals within 1e-6
      (measured on an H100: 1.7e-6, 3.3e-6 and 1.8e-7).

    risk_obs is not held: these candidates' projection residuals are
    float32 round-off (6e-6 to 1.2e-5), the card sorts them in another order
    than the CPU, and the Beta draws go to a candidate by its place in that
    order, so a candidate's mother rollouts differ between the two runs
    (ROADMAP Queue 3)."""
    from mpc_mmd_tpu_torch import static_workload
    from mpc_mmd_tpu_torch import solver as solver_mod
    monkeypatch.setenv("MPC_MMD_SELECTION", selection)
    cfg = static_workload(num_reduced=N, num_obs=2, noise="beta", noise_level=0.3)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=1),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                   maxiter=4))
    arrays, record = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg, 0)
    t = np.linspace(0.0, 15.0, 100)
    xo = np.stack([8.0 + 0 * t, 13.0 + 0 * t])
    yo = np.stack([1.75 + 0 * t, 0.6 + 0 * t])
    args = ([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
            np.diag([20.0] * 4 + [100.0] * 4), xo, yo, 15.0)
    inner = solver_mod.select_reduced_set_batched
    seen = []
    monkeypatch.setattr(solver_mod, "select_reduced_set_batched",
                        lambda c, *a, **kw: seen.append(a) or inner(c, *a, **kw))
    h = Solver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu", record)).solve(0, *args)
    # every selection's inner CEM is kernel (c) in its form, once an outer
    # iteration
    from mpc_mmd_tpu_torch.ops.inner_cem import FORMS
    own = FORMS.get(selection, inner_cem)
    before = (inner_cem.launches, own.launches)
    g = Solver(cfg, device="cuda", noise=FixedNoise(arrays, "cuda")).solve(0, *args)
    n = cfg.cem.maxiter_cem
    assert (inner_cem.launches, own.launches) == (before[0] + n, before[1] + n)
    torch.testing.assert_close(g.cx.cpu(), h.cx, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g.cy.cpu(), h.cy, rtol=1e-5, atol=1e-3)
    cpu_in = seen[0]
    ref = inner(cfg, *cpu_in)
    got = inner(cfg, *(t.cuda() for t in cpu_in[:4]), seen[1][4])
    for name in ("x_red", "y_red"):
        assert torch.equal(getattr(got, name).cpu(), getattr(ref, name))
    for name, tol in (("beta", 1e-5), ("sigma", 1e-5), ("res", 1e-6)):
        torch.testing.assert_close(getattr(got, name).cpu(), getattr(ref, name),
                                   rtol=0, atol=tol)


def test_dynamic_fused_outer_iteration_cuda_matches_cpu(cuda, monkeypatch):
    """Path A (dynamic workload, Beta noise, fused selection: kernel (c)'s
    fused form on the card) for one outer iteration: the CPU run records its
    Beta draws and the card replays them."""
    from mpc_mmd_tpu_torch.ops.inner_cem import FORMS
    monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    cfg = dynamic_workload(num_reduced=4, num_obs=2, noise_level=0.2)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=1),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                   maxiter=4))
    arrays, record = record_solve_draws(TorchNoise(torch.Generator(), "cpu"),
                                        cfg, 0)
    t = np.linspace(0.0, 15.0, 100)
    xo = np.stack([8.0 + 0 * t, 13.0 + 0 * t])
    yo = np.stack([-1.75 + 0 * t, -1.5 + 0 * t])
    args = ([0.0, -1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
            np.diag([20.0] * 4 + [100.0] * 4), xo, yo, 15.0)
    h = Solver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu", record)).solve(0, *args)
    assert arrays["beta"].shape == (1, 2, 16, 4, cfg.horizon.num_prime)
    before = (FORMS["fused"].launches, topk_kernel_matrices.launches)
    g = Solver(cfg, device="cuda", noise=FixedNoise(arrays, "cuda")).solve(0, *args)
    assert (FORMS["fused"].launches, topk_kernel_matrices.launches) == (
        before[0] + cfg.cem.maxiter_cem, before[1])
    torch.testing.assert_close(g.cx.cpu(), h.cx, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g.cy.cpu(), h.cy, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g.risk_obs.cpu(), h.risk_obs, rtol=1e-3, atol=1e-3)


def test_one_outer_iteration_cuda_matches_cpu(cuda):
    cfg = fastrt_workload(num_reduced=4, num_obs=2)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=1))
    arrays, _ = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg, 0)
    t = np.linspace(0.0, 15.0, 100)
    xo = np.stack([8.0 + 0 * t, 13.0 + 0 * t])
    yo = np.stack([1.75 + 0 * t, 0.6 + 0 * t])
    out = []
    for dev in ("cuda", "cpu"):
        s = Solver(cfg, device=dev, noise=FixedNoise(arrays, dev))
        r = s.solve(0, [0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
                    np.diag([20.0] * 4 + [100.0] * 4), xo, yo, 15.0)
        out.append(r)
    g, h = out
    torch.testing.assert_close(g.cx.cpu(), h.cx, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g.cy.cpu(), h.cy, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(g.risk_obs.cpu(), h.risk_obs, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("noise", ["gaussian", "beta"])
def test_validator_cuda_matches_cpu(cuda, noise):
    """The MC validator on the card (K4) against the CPU with identical
    draws: counts within one per solve (a rollout grazing a bound can flip
    on K4's last-ulp differences), collision fractions within 1/n_mc."""
    from mpc_mmd_tpu_torch import static_workload
    from mpc_mmd_tpu_torch.qp import build_workspace
    from mpc_mmd_tpu_torch.validate import make_validator
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=50, noise=noise,
                          noise_level=0.3, steer_const_noise=0.02)
    S, n_mc, T = 6, 1000, 50
    ws = build_workspace(cfg, "cpu")
    t = np.linspace(0.0, 15.0, 100)
    P = ws.P.double().numpy()
    cx = np.stack([np.linalg.lstsq(P, (5 + 0.3 * i) * t, rcond=None)[0]
                   for i in range(S)]).astype(np.float32)
    cy = np.stack([np.linalg.lstsq(P, 1.75 - 0.02 * i * t, rcond=None)[0]
                   for i in range(S)]).astype(np.float32)
    xo = np.zeros((S, 2, 100), np.float32)
    yo = np.full((S, 2, 100), -1.75, np.float32)
    xo[:, 0] = (12.0 + 2.0 * np.arange(S))[:, None]
    yo[:, 0] = -0.9
    xo[:, 1] = 300.0
    g = torch.Generator().manual_seed(0)
    arrays = {f"mc_eps_{n}": torch.randn(S, n_mc, T, generator=g).numpy()
              for n in ("acc", "steer", "const")}
    arrays["mc_beta"] = torch.rand(S, 2, n_mc, T, generator=g).numpy()
    init = np.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        v = make_validator(cfg, build_workspace(cfg, dev), n_mc,
                           FixedNoise(arrays, dev))
        before = fused_rollout.launches
        out[dev] = [x.cpu().numpy() for x in v(cx, cy, init, xo, yo)]
        assert fused_rollout.launches == before + (dev == "cuda")
    for i in range(2):
        assert np.abs(out["cuda"][i].astype(np.int64) - out["cpu"][i]).max() <= 1
    assert np.abs(out["cuda"][2] - out["cpu"][2]).max() <= 1.0 / n_mc + 1e-7
    assert out["cpu"][0].max() > 0


def test_frenet_outer_iteration_cuda_matches_cpu(cuda):
    """One outer iteration of the on-road mmd_opt solve (kernel (c), K4n
    with a state per lane, 16 mother rollouts from 16 noisy initial states,
    kernels (f) and (g)) on the card against the CPU with identical draws
    and the same frame: the controls within 1e-3."""
    from mpc_mmd_tpu_torch import FrenetSolver, onroad_workload
    from mpc_mmd_tpu_torch.closedloop import SyntheticPlant, local_problem, make_route
    from mpc_mmd_tpu_torch.frenet import build_smoother
    cfg = onroad_workload(num_reduced=4, num_obs=2)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=1),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                   maxiter=4))
    plant = SyntheticPlant(cfg, make_route("curved"), ((12.0, 0.5), (18.0, 3.0)))
    tot_time = torch.linspace(0.0, 15.0, 100, device="cuda")
    frame, xo, yo, init = local_problem(cfg, plant, build_smoother(device="cuda"),
                                        tot_time)
    arrays, _ = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg, 0)
    args = (init, [10.0] * 4 + [0.0] * 4, np.diag([20.0] * 4 + [100.0] * 4),
            xo, yo, 10.0, frame)
    before = noisy_rollout.launches
    g = FrenetSolver(cfg, device="cuda", noise=FixedNoise(arrays, "cuda")).solve(0, *args)
    assert noisy_rollout.launches == before + 1
    h = FrenetSolver(cfg, device="cpu", noise=FixedNoise(arrays, "cpu")).solve(0, *args)
    for name in ("v_best", "steering_best"):
        torch.testing.assert_close(getattr(g, name).cpu(), getattr(h, name),
                                   rtol=0, atol=1e-3)


def _chunk_case(strategy="prefactored"):
    cfg = fastrt_workload(num_reduced=4, num_obs=2)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=24, maxiter_cem=2),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=16,
                                                   maxiter=3),
                      solve_strategy=strategy)
    t = torch.linspace(0.0, 15.0, 100, device="cuda")
    xs = torch.stack([torch.stack([8.0 + 0.37 * i + 0 * t, 13.0 + 0.53 * i + 0 * t])
                      for i in range(3)])
    ys = torch.stack([torch.stack([1.75 - 0.11 * i + 0 * t, 0.6 + 0.13 * i + 0 * t])
                      for i in range(3)])
    args = [torch.tensor(a, dtype=torch.float32, device="cuda")
            for a in ([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
                      np.diag([20.0] * 4 + [100.0] * 4))]
    return cfg, xs, ys, args


def test_chunk_on_the_card_equals_its_scenarios_one_at_a_time(cuda):
    """A chunk of 3 tie-free scenarios in one outer loop on the card: each
    scenario within 1e-4 of its scale of the same scenario solved alone,
    and the chunk launches each kernel as often as one solve does."""
    cfg, xs, ys, (init, mean, cov) = _chunk_case()
    solver = Solver(cfg, device="cuda", scenario_chunk=3)
    # the "xla" selection's inner CEM is kernel (c), one launch an outer
    # iteration; K1 and K2 launch only under the other selections; the
    # rollouts are K4n's
    counts = lambda: [f.launches for f in (inner_cem, topk_indices, eq_qp_solve,
                                           noisy_rollout)]
    before = counts()
    one = solver.solve(5, init, mean, cov, xs[0], ys[0], 15.0)
    per_solve = [b - a for a, b in zip(before, counts())]
    before = counts()
    batch = solver.solve_batch([5, 6, 7], init, mean, cov, xs, ys, 15.0)
    assert [b - a for a, b in zip(before, counts())] == per_solve
    outer = cfg.cem.maxiter_cem
    assert per_solve == [outer, 0, 0, outer]
    for i, seed in enumerate((5, 6, 7)):
        ref = one if i == 0 else solver.solve(seed, init, mean, cov, xs[i], ys[i], 15.0)
        for name in ("cx", "cy", "risk_obs", "res", "mean_param"):
            r = getattr(ref, name)
            scale = max(1.0, float(r.abs().max()))
            torch.testing.assert_close(getattr(batch, name)[i], r, rtol=0,
                                       atol=1e-4 * scale)


def test_exact_solve_on_the_card_makes_no_host_sync(cuda):
    """The exact strategy on the card, its inputs already there: no call
    synchronises with the host (the sync debug mode raises on one), and
    only K4 of the kernels is launched."""
    cfg, xs, ys, (init, mean, cov) = _chunk_case("exact")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1))
    solver = Solver(cfg, device="cuda")
    solver.solve(1, init, mean, cov, xs[0], ys[0], 15.0)
    torch.cuda.synchronize()
    before = [f.launches for f in (topk_indices, eq_qp_solve, fused_rollout)]
    torch.cuda.set_sync_debug_mode("error")
    try:
        r = solver.solve(2, init, mean, cov, xs[1], ys[1], 15.0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = [f.launches for f in (topk_indices, eq_qp_solve, fused_rollout)]
    assert [b - a for a, b in zip(before, after)] == [0, 0, 1]
    assert bool(torch.isfinite(r.cx).all()) and bool(torch.isfinite(r.risk_obs))


# Chunk sizes held bit for bit: the counts the earlier checks held and,
# past them, 16 to 64 scenarios (``utils/chunk_bits.py`` has the families
# and their shapes, and tries every count on the card)
CHUNKS = (16, 17, 24, 32, 33, 48, 64)


@pytest.mark.parametrize("rows,K,N", chunk_bits.SCENARIO_MM)
def test_scenario_mm_gives_a_scenario_its_bits_in_any_chunk(cuda, rows, K, N):
    """Each scenario's rows of ``scenario_mm`` over 2-64 scenarios equal
    that scenario's product alone, bit for bit, and the product is a GEMM's
    to float32 round-off."""
    assert chunk_bits.failing_counts("scenario_mm", (rows, K, N),
                                     (2, 3, 4, 5, 8) + CHUNKS, cuda) == []
    w = torch.randn(K, N, device="cuda", generator=cuda)
    x = torch.randn(rows, K, device="cuda", generator=cuda)
    torch.testing.assert_close(scenario_mm(x, w), x @ w, rtol=1e-5, atol=1e-4)


def test_outer_cem_cholesky_gives_a_scenario_its_bits_in_any_chunk(cuda):
    """The outer CEM's factors of 1-64 covariances at once equal each
    factored alone, bit for bit; a covariance that is not positive definite
    gives NaN."""
    assert chunk_bits.failing_counts("cholesky", (8,), tuple(range(1, 9)) + CHUNKS,
                                     cuda) == []
    L = torch.randn(8, 8, 8, device="cuda", generator=cuda)
    A = L @ L.mT + 0.1 * torch.eye(8, device="cuda")
    torch.testing.assert_close(_cholesky(A[0]), torch.linalg.cholesky(A[0]),
                               rtol=1e-5, atol=1e-5)
    bad = torch.stack((A[0], -torch.eye(8, device="cuda")))
    out = _cholesky(bad)
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1]).all())


@pytest.mark.parametrize("S,n_el,M1,nb", chunk_bits.RESAMPLE)
def test_inner_resample_gives_a_candidate_its_bits_in_any_chunk(cuda, S, n_el, M1, nb):
    """The inner CEM's resample ``A_t @ elites`` over the candidates of
    1-64 scenarios: each scenario's candidates equal them alone."""
    assert chunk_bits.failing_counts("resample", (S, n_el, M1, nb),
                                     (2, 3, 4, 8) + CHUNKS, cuda) == []


@pytest.mark.parametrize("M,nb", chunk_bits.PAIRWISE_L2SQ)
def test_pairwise_l2sq_gives_a_candidate_its_bits_in_any_chunk(cuda, M, nb):
    """``pairwise_l2sq`` of the refitted features (C, M, 22) of 1-64
    scenarios' candidates: each scenario's block equals it alone."""
    assert chunk_bits.failing_counts("pairwise_l2sq", (M, nb),
                                     (2, 3, 4, 8) + CHUNKS, cuda) == []


def _keys(gen, K):
    return torch.randint(0, 2 ** 32, (K, 2), generator=gen, device="cuda",
                         dtype=torch.int64)


def _ulp_gap(a, b):
    ia, ib = (t.contiguous().view(torch.int32).to(torch.int64) for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("K,n", [(1, 1), (1, 472), (3, 500), (7, 1001), (768, 50_000)])
def test_prng_draws_kernel_matches_twin(cuda, K, n):
    """Kernel (a): bits equal; uniforms and normals within 1 ulp (equal but
    where the twin's double-rounded fma meets a tie)."""
    from mpc_mmd_tpu_torch import prng
    from mpc_mmd_tpu_torch.ops import prng_draws
    keys = _keys(cuda, K)
    assert torch.equal(prng_draws(keys, n, "bits"), prng.draws(keys, n, "bits"))
    for dist in ("uniform", "normal"):
        assert _ulp_gap(prng_draws(keys, n, dist), prng.draws(keys, n, dist)) <= 1


def _deep_inner_chain(gen, n):
    """A key and an element whose first gamma's first round rejects both
    inner normals that kernel (b) caches (``kCachedNormals``) at the
    largest c of a solve (alpha = 1e-8: d = 2/3), so that its candidates
    walk the inner chain on themselves."""
    from mpc_mmd_tpu_torch import prng
    keys = _keys(gen, -(-2_000_000 // n))                    # ~100 such chains
    ke = prng.split(prng.split(keys)[:, 0], n)               # (tries, n, 2)
    xk = prng.split(prng.split(ke)[..., 0, :], 3)[..., 1, :]  # round 1's inner key
    d = np.float32(1.0) - np.float32(1.0 / 3.0)
    c = float(np.float32(1.0 / 3.0) / np.sqrt(d))
    rejected = torch.ones(ke.shape[:2], dtype=torch.bool, device="cuda")
    for _ in range(2):
        xk, s = prng.split(xk).unbind(-2)
        rejected &= prng.fma(prng.normal(s), c, 1.0) <= 0.0
    t, e = (int(i) for i in rejected.nonzero()[0])
    return keys[t], e


@pytest.mark.parametrize("K,B,n,P,mixed", [
    (2, 100, 500, 50, False), (8, 100, 500, 50, False), (2, 100, 250, 50, False),
    (2, 100, 750, 50, False), (40, 1, 50_000, 50, False), (3, 2, 7, 7, False),
    (2, 1, 500, 50, True), (2, 31, 500, 50, True), (2, 33, 500, 50, True),
    (2, 100, 500, 50, True), (2, 400, 500, 50, True)])
def test_prng_beta_kernel_matches_twin(cuda, K, B, n, P, mixed):
    """Kernel (b) at the solves' parameters (1e-8-floored |u| times 2 and 5,
    u = 0 at the first step) or at candidates of mixed alpha (10^-8 to
    10^2, so that the candidates of one element take other round counts),
    with Beta(0, 0), which is NaN in both, and, beside several candidates,
    an element whose chain rejects every cached inner normal: within rtol
    1e-5 + atol 1e-6 of the twin (the largest gap printed)."""
    from mpc_mmd_tpu_torch import prng
    from mpc_mmd_tpu_torch.ops import prng_beta
    from mpc_mmd_tpu_torch.utils.kernel_ab import beta_inputs
    keys, alpha, beta = beta_inputs(cuda, K, B, P, mixed)
    alpha[0, 0, -1] = beta[0, 0, -1] = 0.0
    if B > 1:
        keys[1], e = _deep_inner_chain(cuda, n)
        alpha[1, 0, e % P] = 1e-8
    got, ref = prng_beta(keys, alpha, beta, n), prng.beta_draws(keys, alpha, beta, n)
    print(f"kernel (b) at {(K, B, n, P)}, mixed alpha {mixed}: largest gap to the twin "
          f"{float((got - ref).abs().nan_to_num(0.0).max()):.3e}")
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert bool(got[0, 0, P - 1::P].isnan().all())


def test_prng_kernels_give_the_jax_reference_draws(cuda):
    """Against jax.random's draws for fixed keys
    (mpc_mmd_tpu_torch/data/prng_reference.npz): bits and uniforms equal,
    normals within 4 ulp, Beta within rtol 1e-5 + atol 1e-6."""
    from pathlib import Path
    from mpc_mmd_tpu_torch.ops import prng_beta, prng_draws
    path = Path(__file__).resolve().parents[1] / "mpc_mmd_tpu_torch" / "data"
    with np.load(path / "prng_reference.npz") as f:
        ref = dict(f)
    keys = torch.as_tensor(ref["keys"], device="cuda")
    n = ref["bits"].shape[1]
    assert np.array_equal(prng_draws(keys, n, "bits").cpu().numpy(), ref["bits"])
    assert np.array_equal(prng_draws(keys, n, "uniform").cpu().numpy(), ref["uniform"])
    assert _ulp_gap(prng_draws(keys, n).cpu(), torch.as_tensor(ref["normal"])) <= 4
    got = prng_beta(*(torch.as_tensor(ref[k], device="cuda")
                      for k in ("beta_keys", "beta_alpha", "beta_beta")),
                    ref["beta"].shape[-1])
    np.testing.assert_allclose(got.cpu().numpy(), ref["beta"], rtol=1e-5, atol=1e-6)


def _plan_config(name):
    """A path's configuration, scenarios a chunk and on-road initial states
    (None on the straight road), for kernel (a)'s plan form."""
    from mpc_mmd_tpu_torch.noise import init_state_count
    if name in ("fastrt", "e8"):
        return fastrt_workload(), 8 if name == "e8" else 1, None
    cfg = _onroad("det" if name == "det" else "mmd_opt")
    return cfg, 1, init_state_count(cfg)


@pytest.mark.parametrize("name", ["fastrt", "e8", "path_d", "det"])
def test_prng_plan_kernel_equals_per_segment_draws(cuda, name):
    """Kernel (a)'s plan form at a solve's plan (``JaxNoise.solve_draws``:
    fastrt, a chunk of 8 of it, Path D with its noisy initial states, det
    without rollout noise): one launch, each segment bit-equal to
    ``prng_draws`` of its keys, and every iteration's views bit-equal to
    the per-iteration draws, ``rollout_eps``, ``cem_z`` and
    ``init_state_z``."""
    from mpc_mmd_tpu_torch.noise import JaxNoise
    from mpc_mmd_tpu_torch.ops import prng_draws, prng_plan
    cfg, N, n_init = _plan_config(name)
    c, R, T = cfg.cem, cfg.risk.num_reduced, cfg.horizon.num_prime
    noise = JaxNoise("cuda")
    table = noise.keys(list(range(5, 5 + N)), c.maxiter_cem).cuda()
    init = None if n_init is None else (noise.init_key(5), n_init)
    R = None if name == "det" else R
    n_cem = c.num_batch - c.ellite_num
    before = prng_plan.launches
    got = noise.solve_draws(table, R, T, n_cem, c.num_params, init)
    assert prng_plan.launches == before + 1
    for it in range(c.maxiter_cem):
        col = table[:, it]
        if R is not None:
            rows = prng_draws(col.reshape(-1, 2), R * T).view(N, 3, R, T)
            for j, e in enumerate(got.eps[it]):
                assert torch.equal(e, rows[:, j])
            for a, b in zip(got.eps[it], noise.rollout_eps(col, R, T)):
                assert torch.equal(a, b)
        assert torch.equal(got.cem_z[it], prng_draws(col[:, 1], n_cem * c.num_params).view(
            N, n_cem, c.num_params))
        assert torch.equal(got.cem_z[it], noise.cem_z(col, n_cem, c.num_params))
    if init is not None:
        assert torch.equal(got.init_z, noise.init_state_z(*init))
    else:
        assert got.init_z is None


@pytest.mark.parametrize("name", ["fastrt", "path_b", "path_d", "det"])
def test_a_graphed_solve_draws_its_noise_in_one_plan_launch(cuda, name):
    """A replay of a graphed solve of each path launches kernel (a)'s plan
    form once and ``prng_draws`` never (the solver-fixed draws are made
    before the capture)."""
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.ops import launch_counts
    cov = np.diag([20.0] * 4 + [100.0] * 4)
    if name in ("fastrt", "path_b"):
        cfg = (fastrt_workload() if name == "fastrt"
               else dynamic_workload(noise_level=0.2, mode="cvar"))
        xs, ys = _static(2)
        solver = Solver(cfg, device="cuda")
        solve = lambda i: solver.solve(i, [0.0, 1.75, 5.0, 0.0, 0.0, 0.0],
                                       [15.0] * 4 + [0.0] * 4, cov, xs[i], ys[i], 15.0)
    else:
        from mpc_mmd_tpu_torch.closedloop import SyntheticPlant, local_problem, make_route
        from mpc_mmd_tpu_torch.frenet import build_smoother
        cfg = _onroad("det" if name == "det" else "mmd_opt")
        plant = SyntheticPlant(cfg, make_route("curved"),
                               ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5)),
                               obstacle_speed=1.0)
        tot_time = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device="cuda")
        frame, xo, yo, init = local_problem(cfg, plant, build_smoother(
            cfg.frenet.num_path, device="cuda"), tot_time)
        solver = FrenetSolver(cfg, device="cuda")
        solve = lambda i: solver.solve(i, init, [10.0] * 4 + [0.0] * 4, cov, xo, yo, 10.0,
                                       frame)
    solve(0)
    torch.cuda.synchronize()
    before = launch_counts()
    solve(1)
    torch.cuda.synchronize()
    got = {k: n - before[k] for k, n in launch_counts().items()}
    assert solver.graph and got["prng_plan"] == 1 and got["prng_draws"] == 0, got


# ---------------------------------------------------------------------------
# The solve as a CUDA graph (graph.py): every replay against the eager card
# solve (graph=False) of the same inputs
# ---------------------------------------------------------------------------

def graph_against_eager(make, calls):
    """Each of ``calls`` (a function of a solver) on a graphed solver,
    ``make(None)``, and on an eager one, ``make(False)``: the results bit
    for bit equal and the launch counts equal; every call after the first
    (a replay) under CUDA's sync debug mode at "error"; every result kept
    unchanged to the end.  Returns the graphed solver."""
    from mpc_mmd_tpu_torch.ops import launch_counts
    graphed, eager = make(None), make(False)
    assert graphed.graph and not eager.graph
    kept = []
    for i, call in enumerate(calls):
        outs, counts = [], []
        for solver in (graphed, eager):
            torch.cuda.synchronize()
            before = launch_counts()
            if solver is graphed and i:
                torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(call(solver))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            counts.append({k: n - before[k] for k, n in launch_counts().items()})
        got, ref = outs
        assert counts[0] == counts[1] and sum(counts[0].values()) > 0, counts
        for name, a, b in zip(got._fields, got, ref):
            assert torch.equal(a, b), (i, name)
        kept.append((got, [t.clone() for t in got]))
    for got, copy in kept:
        assert all(torch.equal(a, b) for a, b in zip(got, copy))
    stats = graphed.graph_stats()
    assert stats and all(s["nodes"] > 0 and s["launches"] for s in stats)
    return graphed


def _static(n, num_obs=6):
    t = torch.linspace(0.0, 15.0, 100, device="cuda")
    return (torch.stack([torch.stack([30.0 + 5.0 * i + j + 0 * t for j in range(num_obs)])
                         for i in range(n)]),
            torch.stack([torch.stack([(-1.75 if (i + j) % 2 else 1.75) + 0 * t
                                      for j in range(num_obs)]) for i in range(n)]))


def test_graphed_fastrt_solve_equals_the_eager_card_solve(cuda):
    """The full-width fastrt solve, three solves of other seeds, scenarios,
    initial states and v_des on one solver (the first captures)."""
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50)
    xs, ys = _static(3)
    mean, cov = [15.0] * 4 + [0.0] * 4, np.diag([20.0] * 4 + [100.0] * 4)
    calls = [lambda s, i=i: s.solve(i, [0.0, 1.75 - 0.1 * i, 5.0 + i, 0.0, 0.0, 0.0],
                                    mean, cov, xs[i], ys[i], 15.0 - i)
             for i in range(3)]
    g = graph_against_eager(lambda graph: Solver(cfg, device="cuda", graph=graph), calls)
    assert [s["replays"] for s in g.graph_stats()] == [2]


def test_graphed_chunks_with_a_short_last_one_equal_the_eager_ones(cuda):
    """``solve_batch`` of 7 scenarios at chunk 4 (a chunk of 4 and a short
    one of 3, a graph each), twice with other seeds."""
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50)
    xs, ys = _static(7)
    args = ([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], [15.0] * 4 + [0.0] * 4,
            np.diag([20.0] * 4 + [100.0] * 4), xs, ys, 15.0)
    calls = [lambda s, lo=lo: s.solve_batch(list(range(lo, lo + 7)), *args)
             for lo in (0, 20)]
    g = graph_against_eager(lambda graph: Solver(cfg, device="cuda", scenario_chunk=4,
                                                 graph=graph), calls)
    chunks = [next(shape for name, shape, _ in s["key"][:-1] if name == "keys")[0]
              for s in g.graph_stats()]
    assert chunks == [4, 3] and [s["replays"] for s in g.graph_stats()] == [1, 1]


def test_graphed_path_a_fused_beta_solve_equals_the_eager_one(cuda, monkeypatch):
    """Path A: the dynamic cut-in workload at full width, Beta noise 0.2,
    the fused selection (kernel (c)'s fused form), three cut-in scenarios."""
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state
    monkeypatch.setenv("MPC_MMD_FUSED_CEM", "1")
    cfg = dynamic_workload(num_reduced=10, num_obs=6, noise="beta", noise_level=0.2,
                           num_prime=50, mode="mmd_opt")
    init, mean, cov, v_des = ego_initial_state("dynamic")
    cut = dynamic_cutin(cfg, 3, device="cuda")
    calls = [lambda s, i=i: s.solve(i, init, mean, cov, cut.x_traj[i], cut.y_traj[i],
                                    v_des) for i in range(3)]
    g = graph_against_eager(lambda graph: Solver(cfg, device="cuda", graph=graph), calls)
    launches = g.graph_stats()[0]["launches"]
    assert launches["inner_cem_fused"] == launches["inner_cem"] == 20
    assert "topk_kernel_matrices" not in launches


def test_graphed_frenet_episode_steps_equal_the_eager_ones(cuda):
    """Path D's on-road mmd_opt solve over 3 steps of a plant whose state,
    frame, obstacles, mean and v_des all change between steps."""
    from mpc_mmd_tpu_torch import FrenetSolver, onroad_workload
    from mpc_mmd_tpu_torch.closedloop import SyntheticPlant, local_problem, make_route
    from mpc_mmd_tpu_torch.frenet import build_smoother
    cfg = onroad_workload(num_reduced=4, num_obs=4, num_prime=50)
    plant = SyntheticPlant(cfg, make_route("curved"),
                           ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5)),
                           obstacle_speed=1.0)
    smoother = build_smoother(cfg.frenet.num_path, device="cuda")
    tot_time = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device="cuda")
    steps = []
    for k in range(3):
        frame, xo, yo, init = local_problem(cfg, plant, smoother, tot_time)
        mean = [10.0 + k] * 4 + [0.3 * k] * 4
        steps.append((k, init, mean, np.diag([20.0] * 4 + [100.0] * 4), xo, yo,
                      10.0 + 2 * k, frame))
        plant.step(1.0, 0.02)
    calls = [lambda s, a=a: s.solve(*a) for a in steps]
    graph_against_eager(lambda graph: FrenetSolver(cfg, device="cuda", graph=graph), calls)


@pytest.mark.parametrize("name,N,frenet", [
    ("fastrt", 1, False), ("fastrt", 4, False), ("fastrt", 32, False),
    ("path_a", 1, False), ("path_d", 1, True)])
def test_outer_project_kernel_matches_its_plain_version(cuda, name, N, frenet):
    """Kernel (d) against its plain version on the card from
    ``kernel_ab.kd_inputs`` (row 1 past v_max, the carried state of an
    iteration before, on the road a path): every output within rtol 1e-5 +
    atol 1e-6, NaN only against NaN."""
    from mpc_mmd_tpu_torch import onroad_workload
    from mpc_mmd_tpu_torch.ops import outer_project
    from mpc_mmd_tpu_torch.ops.outer_project import outer_project_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kd_inputs
    cfg = {"fastrt": fastrt_workload(), "path_a": dynamic_workload(noise_level=0.2),
           "path_d": onroad_workload()}[name]
    args, kw = kd_inputs(cuda, cfg, N, frenet)
    before = outer_project.launches
    got = outer_project(*args, **kw)
    assert outer_project.launches == before + 1
    ref = outer_project_plain(*args, **kw)
    for field, g, r in zip(got._fields, got, ref):
        both_nan = g.isnan() & r.isnan()
        ok = ((g - r).abs() <= 1e-5 * r.abs() + 1e-6) | both_nan
        assert bool(ok.all()), field


@pytest.mark.parametrize("name,N,frenet,nonpd", [
    ("fastrt", 1, False, False), ("fastrt", 1, False, True), ("fastrt", 4, False, False),
    ("fastrt", 32, False, False), ("path_a", 1, False, False),
    ("path_d", 1, True, False)])
def test_outer_tail_kernel_matches_its_plain_version(cuda, name, N, frenet, nonpd):
    """Kernel (e) against its plain version on the card from
    ``kernel_ab.ke_inputs`` (the best elite copied: a tie in risk and in
    cost; with ``nonpd`` a covariance that is not positive definite), at
    every cluster size: the kept, the elites and the pick exact, the
    moments, parameters, risks and res within rtol 1e-5 + atol 1e-6."""
    from mpc_mmd_tpu_torch import onroad_workload
    from mpc_mmd_tpu_torch.ops import outer_tail
    from mpc_mmd_tpu_torch.ops.outer_tail import outer_tail_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import ke_inputs
    cfg = {"fastrt": fastrt_workload(), "path_a": dynamic_workload(noise_level=0.2),
           "path_d": onroad_workload()}[name]
    args = ke_inputs(cuda, cfg, N, frenet, nonpd)
    res_p = args[15].clone()
    ref = outer_tail_plain(*args[:15], res_p, args[16].clone(), args[17])
    for cluster in (0, 1, 2, 4, 8):
        res_k = args[15].clone()
        got = outer_tail(*args[:15], res_k, args[16].clone(), args[17], cluster=cluster)
        for field in ("kept", "elites", "best"):
            assert torch.equal(getattr(got, field), getattr(ref, field)), (field, cluster)
        for field, g, r in (("mean", got.mean, ref.mean), ("cov", got.cov, ref.cov),
                            ("params", got.params, ref.params),
                            ("risk_obs", got.risk_obs, ref.risk_obs),
                            ("risk_lane", got.risk_lane, ref.risk_lane),
                            ("res", res_k, res_p)):
            both_nan = g.isnan() & r.isnan()
            ok = ((g - r).abs() <= 1e-5 * r.abs() + 1e-6) | both_nan
            assert bool(ok.all()), (field, cluster)


def _bits(a, b):
    """Bit for bit, NaN equal to NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("forced", [
    {}, {"rows_per_cta": 1}, {"rows_per_cta": 2}, {"runtime_shape": True},
    {"rows_per_cta": 2, "runtime_shape": True}])
@pytest.mark.parametrize("name,N,frenet", [
    ("fastrt", 1, False), ("fastrt", 32, False), ("path_d", 1, True)])
def test_outer_project_launch_choices_give_the_plain_chain_bits(cuda, name, N, frenet,
                                                                forced):
    """Kernel (d) at the path shapes, at its compile-time and run-time-shape
    instantiations and at one and two rows a CTA: every output bit-equal to
    the plain chain on the card (NaN to NaN)."""
    from mpc_mmd_tpu_torch import onroad_workload
    from mpc_mmd_tpu_torch.ops import outer_project
    from mpc_mmd_tpu_torch.ops.outer_project import outer_project_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kd_inputs
    cfg = {"fastrt": fastrt_workload(), "path_d": onroad_workload()}[name]
    args, kw = kd_inputs(cuda, cfg, N, frenet)
    got = outer_project(*args, **kw, **forced)
    ref = outer_project_plain(*args, **kw)
    for field, g, r in zip(got._fields, got, ref):
        assert _bits(g, r), field


@pytest.mark.parametrize("rows_per_cta", [1, 2])
def test_outer_project_runtime_shape_at_another_num(cuda, rows_per_cta):
    """The run-time-shape instantiation at num 60 (no compile-time one):
    every output within rtol 1e-5 + atol 1e-6 of the plain chain."""
    from mpc_mmd_tpu_torch.ops import outer_project
    from mpc_mmd_tpu_torch.ops.outer_project import launch_choice, outer_project_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kd_inputs
    cfg = fastrt_workload()
    cfg = cfg.replace(horizon=dataclasses.replace(cfg.horizon, num=60))
    assert not launch_choice(11, 60, 4, 64)[1]
    args, kw = kd_inputs(cuda, cfg, 1)
    got = outer_project(*args, **kw, rows_per_cta=rows_per_cta)
    ref = outer_project_plain(*args, **kw)
    for field, g, r in zip(got._fields, got, ref):
        both_nan = g.isnan() & r.isnan()
        assert bool((((g - r).abs() <= 1e-5 * r.abs() + 1e-6) | both_nan).all()), field


@pytest.mark.parametrize("name,N,frenet", [
    ("fastrt", 1, False), ("fastrt", 4, False), ("path_a", 1, False), ("path_d", 1, True)])
def test_outer_tail_every_cta_keeps_the_same_candidates(cuda, name, N, frenet):
    """Kernel (e) at every cluster size: each CTA ranks the risks itself and
    keeps the candidates that rank 0 returns, and every output (res and
    res_2 too) is bit-equal to the plain chain on the card."""
    from mpc_mmd_tpu_torch import onroad_workload
    from mpc_mmd_tpu_torch.ops import outer_tail
    from mpc_mmd_tpu_torch.ops.outer_tail import outer_tail_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import ke_inputs
    cfg = {"fastrt": fastrt_workload(), "path_a": dynamic_workload(noise_level=0.2),
           "path_d": onroad_workload()}[name]
    args = ke_inputs(cuda, cfg, N, frenet)
    r1, r2 = args[15].clone(), args[16].clone()
    ref = tuple(outer_tail_plain(*args[:15], r1, r2, args[17])) + (r1, r2)
    n_cost = ref[6].shape[1]
    for cluster in (1, 2, 4, 8):
        per_cta = torch.full((N * cluster, n_cost), -1, dtype=torch.int64, device="cuda")
        k1, k2 = args[15].clone(), args[16].clone()
        got = outer_tail(*args[:15], k1, k2, args[17], cluster=cluster, kept_cta=per_cta)
        assert torch.equal(per_cta.reshape(N, cluster, n_cost),
                           got.kept[:, None].expand(N, cluster, n_cost)), cluster
        for i, (g, r) in enumerate(zip(tuple(got) + (k1, k2), ref)):
            assert _bits(g, r), (i, cluster)


def _workload(name, mode="mmd_opt"):
    from mpc_mmd_tpu_torch import onroad_workload
    cfg = {"fastrt": fastrt_workload(), "path_a": dynamic_workload(noise_level=0.2),
           "path_d": onroad_workload()}[name]
    return cfg.with_risk_mode(mode)


def _same_bits(got, ref):
    return bool(((got == ref) | (got.isnan() & ref.isnan())).all())


@pytest.mark.parametrize("name,N,mode", [
    ("fastrt", 1, "mmd_opt"), ("fastrt", 4, "mmd_opt"), ("path_a", 1, "cvar"),
    ("path_d", 1, "mmd_opt")])
def test_noisy_rollout_kernel_equals_its_plain_version(cuda, name, N, mode):
    """K4n against its plain version on the card (perturb_controls, the
    mother pairing and K4) from ``kernel_ab.k4n_inputs``: gaussian mother
    rollouts, Beta noise's R rollouts, the on-road solve's state per lane;
    x and y bit-equal."""
    from mpc_mmd_tpu_torch.ops import noisy_rollout
    from mpc_mmd_tpu_torch.ops.rollout import noisy_rollout_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import k4n_inputs
    args = k4n_inputs(cuda, _workload(name, mode), N, frenet=name == "path_d")
    before = noisy_rollout.launches
    got = noisy_rollout(*args)
    assert noisy_rollout.launches == before + 1
    ref = noisy_rollout_plain(*args)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("name,N,kind,order", [
    ("fastrt", 1, "laplace", 10), ("path_d", 1, "laplace", 10),
    ("fastrt", 4, "matern52", 10), ("fastrt", 1, "gaussian", 7)])
def test_inner_prologue_kernel_equals_its_plain_version(cuda, name, N, kind, order):
    """Kernel (f) against its plain version on the card (the refit's cuBLAS
    products, pairwise_l1 and pairwise_l2sq) from ``kernel_ab.kf_inputs``:
    cx, cy, D and D2 bit-equal, at the paths' nvar 11 (the compile-time
    feature count) and at nvar 8 (the run-time one)."""
    from mpc_mmd_tpu_torch.ops import inner_prologue
    from mpc_mmd_tpu_torch.ops.inner_prologue import inner_prologue_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kf_inputs
    cfg = _workload(name)
    cfg = cfg.replace(horizon=dataclasses.replace(cfg.horizon, order=order))
    args = kf_inputs(cuda, cfg, N, kind)
    before = inner_prologue.launches
    got = inner_prologue(*args)
    assert inner_prologue.launches == before + 1
    ref = inner_prologue_plain(*args)
    assert (got.D2 is None) == (kind == "laplace")
    assert all(_same_bits(g, r) for g, r in zip(got, ref) if r is not None)


def _record(N):
    from mpc_mmd_tpu_torch import static_workload
    return static_workload(num_reduced=N, num_obs=6, num_prime=50, noise="beta",
                           noise_level=0.3, mode="mmd_opt")


def _steps(cfg, T):
    return cfg.replace(horizon=dataclasses.replace(cfg.horizon, num_prime=T))


@pytest.mark.parametrize("cfg,N,frenet,const", [
    (lambda: _steps(_workload("fastrt"), 37), 1, False, 0.0),        # run-time T
    (lambda: _steps(_workload("path_a", "cvar"), 64), 2, True, 0.0),  # Beta, R, T 64
    (lambda: _workload("path_a"), 1, True, 0.02),     # Beta, mother, a state per lane
    (lambda: _workload("path_a", "cvar"), 4, False, 0.0),             # EB4
    (lambda: _workload("path_d", "cvar"), 1, True, 0.0),              # R = 4 lanes
    (lambda: _workload("fastrt"), 32, False, 0.01),   # 11a's chunk of 32
    (lambda: _record(15), 1, False, 0.0), (lambda: _record(5), 1, False, 0.0)])
def test_noisy_rollout_kernel_at_its_edges(cuda, cfg, N, frenet, const):
    """K4n against its plain version on the card, x and y bit for bit:
    T 37 and 64 (the run-time instantiation), Beta draws with a state per
    lane, mother pairing on and off, const noise, 11a's chunk of 32
    scenarios and the record cells' R = 15 and 5."""
    from mpc_mmd_tpu_torch.ops.rollout import noisy_rollout_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import k4n_inputs
    args = k4n_inputs(cuda, cfg(), N, frenet, const)
    before = noisy_rollout.launches
    got = noisy_rollout(*args)
    assert noisy_rollout.launches == before + 1
    ref = noisy_rollout_plain(*args)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))


def test_noisy_rollout_wrapper_refuses_staging_past_shared_memory(cuda):
    from mpc_mmd_tpu_torch.utils.kernel_ab import k4n_inputs
    args = k4n_inputs(cuda, _steps(_workload("fastrt"), 900), 1)
    with pytest.raises(ValueError):
        noisy_rollout(*args)


@pytest.mark.parametrize("cfg,N,kind", [
    (lambda: _record(15), 1, "laplace"), (lambda: _record(15), 1, "gaussian"),
    (lambda: _record(5), 1, "matern52"), (lambda: _workload("fastrt"), 32, "laplace"),
    (lambda: _steps(_workload("path_d"), 37), 2, "gaussian"),          # run-time T
    (lambda: _workload("fastrt").replace(horizon=dataclasses.replace(
        _workload("fastrt").horizon, order=4)), 1, "laplace")])           # nvar 5
def test_inner_prologue_kernel_at_every_cluster_size(cuda, cfg, N, kind):
    """Kernel (f) at F15's M = 225, F5, 11a's chunk of 32 (2,048
    candidates), a run-time T and nvar 5, at its own launch shape and at
    every forced cluster size that fits: cx, cy, D and D2 bit-equal to the
    plain version, and D and D2 bit-symmetric on the card."""
    from mpc_mmd_tpu_torch.ops import inner_prologue
    from mpc_mmd_tpu_torch.ops.inner_prologue import (CLUSTERS, MAX_SMEM,
                                                      inner_prologue_plain, smem_bytes)
    from mpc_mmd_tpu_torch.utils.kernel_ab import kf_inputs
    args = kf_inputs(cuda, cfg(), N, kind)
    ref = inner_prologue_plain(*args)
    _, M, T = args[1].shape[1:]
    for c in [None] + [c for c in CLUSTERS
                       if smem_bytes(M, T, args[0].P_prime.shape[1], c) <= MAX_SMEM]:
        got = inner_prologue(*args, cluster=c)
        assert all(_same_bits(g, r) for g, r in zip(got, ref) if r is not None), c
    for mat in (ref.D, ref.D2, got.D, got.D2):
        if mat is not None:
            assert _same_bits(mat, mat.transpose(1, 2))


@pytest.mark.parametrize("N", [1, 4])
def test_frenet_points_kernel_equals_its_plain_version(cuda, N):
    """Kernel (g) against global_to_frenet_points on the card from
    ``kernel_ab.kg_inputs`` (edge points and a NaN included): s and l
    bit-equal."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_points
    from mpc_mmd_tpu_torch.ops import frenet_points
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_inputs
    frame, x, y = kg_inputs(cuda, _workload("path_d"), N)
    before = frenet_points.launches
    got = frenet_points(frame, x, y)
    assert frenet_points.launches == before + 1
    ref = global_to_frenet_points(frame, x, y)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("case", KG_CASES)
def test_frenet_points_kernel_on_adversarial_inputs(cuda, case):
    """Kernel (g) on ``kernel_ab.kg_case``'s adversarial inputs (ties across
    tiles, non-finite points and path points, overflowing squares,
    duplicate path points, ragged sizes, and the two cases that visit every
    tile): s and l bit-equal to global_to_frenet_points on the card, and
    each point's nearest index and its warp's visited tiles (the probe's)
    the twin's (``nearest_pruned``)."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_points
    from mpc_mmd_tpu_torch.ops.frenet_points import frenet_points, nearest_pruned
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case
    frame, x, y = kg_case(case, "cuda")
    got = frenet_points(frame, x, y)
    s, l, idx, visits = frenet_points(frame, x, y, probe=True)
    ref = global_to_frenet_points(frame, x, y)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    assert _same_bits(s, ref[0]) and _same_bits(l, ref[1])
    tidx, tvisits = nearest_pruned(frame, x, y)
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)


def test_frenet_points_kernel_on_a_closed_loop_frame(cuda):
    """Kernel (g) on local_problem's frame 150 m along the curved route
    (``kernel_ab.kg_closedloop``) at Path D's shape: bit-equal to its plain
    version, its indices and visits the twin's; the obstacle form on that
    step's obstacles bit-equal to global_to_frenet_obstacle."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_obstacle, global_to_frenet_points
    from mpc_mmd_tpu_torch.ops import frenet_obstacles
    from mpc_mmd_tpu_torch.ops.frenet_points import frenet_points, nearest_pruned
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_closedloop
    (frame, x, y), obs = kg_closedloop(cuda, _workload("path_d"))
    got = frenet_points(frame, x, y)
    s, l, idx, visits = frenet_points(frame, x, y, probe=True)
    ref = global_to_frenet_points(frame, x, y)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    assert _same_bits(s, ref[0]) and _same_bits(l, ref[1])
    tidx, tvisits = nearest_pruned(frame, x, y)
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)
    before = frenet_obstacles.launches
    got = frenet_obstacles(frame, obs)
    assert frenet_obstacles.launches == before + 1
    *probed, idx, visits = frenet_obstacles(frame, obs, probe=True)
    assert frenet_obstacles.launches == before + 1
    ref = global_to_frenet_obstacle(frame, *obs.unbind(1))
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    assert all(_same_bits(g, r) for g, r in zip(probed, ref))
    tidx, tvisits = nearest_pruned(frame, obs[:, 0], obs[:, 1])
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)


@pytest.mark.parametrize("n", [1, 4, 16, 100, 128, 256])
@pytest.mark.parametrize("case", ["path_d", "closed_loop", "tie_between_non_adjacent_tiles",
                                  "duplicate_path_points", "nan_path_point",
                                  "squares_overflow"])
def test_frenet_states_kernel_equals_its_plain_version(cuda, case, n):
    """Kernel (g)'s state form against frenet.initial_states on the card:
    the states, b_eq_x and b_eq_y bit-equal, at ``det``'s 1 state, Path D's
    4 and 16 and 100 to 256 (ATen's one-output sums past a warp and
    vectorised), on Path D's, a closed-loop and adversarial frames; its
    probe's nearest indices and visited tiles the twin's."""
    from mpc_mmd_tpu_torch.frenet import initial_states
    from mpc_mmd_tpu_torch.ops import frenet_states
    from mpc_mmd_tpu_torch.ops.frenet_points import nearest_pruned
    from mpc_mmd_tpu_torch.utils.kernel_ab import (kg_case, kg_closedloop, kg_frame,
                                                   kg_state_inputs)
    cfg = _workload("path_d")
    if case == "path_d":
        frame, at = kg_frame("cuda"), (40.0, 1.0)
    elif case == "closed_loop":
        frame, at = kg_closedloop(cuda, cfg)[0][0], (0.0, 0.0)
    else:
        frame, x, y = kg_case(case, "cuda")
        at = (float(x[0]), float(y[0]))
    args = kg_state_inputs(cuda, cfg, frame, n, at)
    before = frenet_states.launches
    got = frenet_states(*args)
    assert frenet_states.launches == before + 1
    ref = initial_states(*args)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    *_, idx, visits = frenet_states(*args, probe=True)
    tidx, tvisits = nearest_pruned(frame, got[0][:, 0], got[0][:, 1])
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)


@pytest.mark.parametrize("case", ["far_off_the_path", "non_finite_query", "inf_path_point",
                                  "duplicate_path_points", "ragged_sizes"])
def test_frenet_obstacles_kernel_equals_its_plain_version(cuda, case):
    """Kernel (g)'s obstacle form against global_to_frenet_obstacle on the
    card, the case's points as obstacle positions with random velocities
    and headings: every output bit-equal, its probe's nearest indices and
    visited tiles the twin's."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_obstacle
    from mpc_mmd_tpu_torch.ops import frenet_obstacles
    from mpc_mmd_tpu_torch.ops.frenet_points import nearest_pruned
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case
    frame, x, y = kg_case(case, "cuda")
    m = x.shape[0]
    obs = torch.stack((x, y, 3.0 * torch.randn(m, device="cuda", generator=cuda),
                       torch.randn(m, device="cuda", generator=cuda),
                       3.0 * torch.rand(m, device="cuda", generator=cuda)), dim=1)
    got = frenet_obstacles(frame, obs)
    ref = global_to_frenet_obstacle(frame, *obs.unbind(1))
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    *_, idx, visits = frenet_obstacles(frame, obs, probe=True)
    tidx, tvisits = nearest_pruned(frame, x, y)
    assert torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)


def _onroad(mode="mmd_opt"):
    from mpc_mmd_tpu_torch import onroad_workload
    return onroad_workload(mode=mode)


@pytest.mark.parametrize("name,N,frenet,mode", [
    ("path_a", 1, False, "cvar"), ("path_a", 1, False, "saa"),
    ("path_a", 1, False, "mmd_random"), ("path_a", 4, False, "cvar"),
    ("path_d", 1, True, "cvar"), ("path_d", 1, True, "saa"),
    ("path_d", 1, True, "mmd_random"), ("path_d", 1, True, "det")])
def test_outer_tail_risk_forms_give_the_plain_chain_bits(cuda, name, N, frenet, mode):
    """Kernel (e)'s other risk forms (Path B's three modes at 100
    candidates, R 10, and its cvar at a chunk of 4; Path D's four, R 4) at
    every cluster size against the plain chain on the card
    (``kernel_ab.ke_inputs``: a rollout with a NaN, a candidate without a
    violation, the best elite copied): every output bit-equal, the kept,
    the elites and the pick exact."""
    from mpc_mmd_tpu_torch.ops import outer_tail
    from mpc_mmd_tpu_torch.ops.outer_tail import outer_tail_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import ke_inputs
    cfg = {"path_a": dynamic_workload(noise_level=0.2, mode=mode),
           "path_d": _onroad(mode)}[name]
    args = ke_inputs(cuda, cfg, N, frenet)
    res_p, res2_p = args[15].clone(), args[16].clone()
    ref = tuple(outer_tail_plain(*args[:15], res_p, res2_p, args[17])) + (res_p, res2_p)
    before = outer_tail.launches
    for cluster in (0, 1, 2, 4, 8):
        res_k, res2_k = args[15].clone(), args[16].clone()
        got = tuple(outer_tail(*args[:15], res_k, res2_k, args[17], cluster=cluster)) + (
            res_k, res2_k)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert _bits(g, r), (i, cluster)
    assert outer_tail.launches == before + 5


@pytest.mark.parametrize("forced", [
    {}, {"rows_per_cta": 1}, {"rows_per_cta": 2}, {"runtime_shape": True},
    {"rows_per_cta": 2, "runtime_shape": True}])
@pytest.mark.parametrize("name,N,frenet", [
    ("path_d", 1, True), ("fastrt", 1, False), ("fastrt", 4, False)])
def test_outer_project_obstacle_form_gives_the_plain_chain_bits(cuda, name, N, frenet,
                                                                forced):
    """Kernel (d)'s obstacle-active form (Path D ``det``, 4 obstacle blocks,
    and a straight solve with 6, alone and at a chunk of 4) at each launch
    choice: every output bit-equal to the plain chain on the card."""
    from mpc_mmd_tpu_torch.ops import outer_project
    from mpc_mmd_tpu_torch.ops.outer_project import outer_project_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kd_inputs
    cfg = {"fastrt": fastrt_workload(), "path_d": _onroad("det")}[name]
    cfg = cfg.replace(projection=dataclasses.replace(cfg.projection,
                                                     with_obstacle_terms=True))
    args, kw = kd_inputs(cuda, cfg, N, frenet)
    got = outer_project(*args, **kw, **forced)
    ref = outer_project_plain(*args, **kw)
    for field, g, r in zip(got._fields, got, ref):
        assert _bits(g, r), field


@pytest.mark.parametrize("mode", ["cvar", "det"])
def test_graphed_path_b_cvar_and_path_d_det_equal_the_eager_ones(cuda, mode):
    """Path B ``cvar`` and Path D ``det``, on kernels (d) and (e): the
    graphed solves bit-equal to the eager ones."""
    from mpc_mmd_tpu_torch import FrenetSolver
    if mode == "cvar":
        from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state
        cfg = dynamic_workload(noise_level=0.2, mode="cvar")
        init, mean, cov, v_des = ego_initial_state("dynamic")
        cut = dynamic_cutin(cfg, 2, device="cuda")
        make = lambda graph: Solver(cfg, device="cuda", graph=graph)
        calls = [lambda s, i=i: s.solve(i, init, mean, cov, cut.x_traj[i], cut.y_traj[i],
                                        v_des) for i in range(2)]
    else:
        from mpc_mmd_tpu_torch.closedloop import SyntheticPlant, local_problem, make_route
        from mpc_mmd_tpu_torch.frenet import build_smoother
        cfg = _onroad("det")
        plant = SyntheticPlant(cfg, make_route("curved"),
                               ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5)),
                               obstacle_speed=1.0)
        tot_time = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device="cuda")
        frame, xo, yo, init = local_problem(cfg, plant, build_smoother(
            cfg.frenet.num_path, device="cuda"), tot_time)
        cov = np.diag([20.0] * 4 + [100.0] * 4)
        make = lambda graph: FrenetSolver(cfg, device="cuda", graph=graph)
        calls = [lambda s, i=i: s.solve(i, init, [10.0 + i] * 4 + [0.0] * 4, cov, xo, yo,
                                        10.0, frame) for i in range(2)]
    graph_against_eager(make, calls)


@pytest.mark.parametrize("maxiter", KH_ROUNDS)
@pytest.mark.parametrize("n", KH_WIDTHS)
@pytest.mark.parametrize("at", KH_AT)
@pytest.mark.parametrize("route", KH_ROUTES)
def test_local_frame_kernel_equals_its_chain_and_twin(cuda, route, at, n, maxiter):
    """Kernel (h) against the chain (frenet.smooth_path, then
    path_parameters) on the card and against its twin: every output
    bit-equal; one counted launch."""
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.ops import local_frame
    from mpc_mmd_tpu_torch.ops.local_frame import local_frame_twin
    x, y = kh_window(route, at, n, "cuda")
    sw = tf.build_smoother(n, maxiter=maxiter, device="cuda")
    before = local_frame.launches
    got = local_frame(sw, x, y, 0.1)
    assert local_frame.launches == before + 1
    ref = tf.path_parameters(*tf.smooth_path(sw, x, y, 0.1))
    twin = local_frame_twin(sw, x, y, 0.1)
    for name, g, r, t in zip(got._fields, got, ref, twin):
        assert _same_bits(g, r), name
        assert _same_bits(t, r), name


@pytest.fixture(scope="module")
def kh_clock_build(tmp_path_factory):
    """Kernel (h)'s clock build (``kernel_ab.glue_clock_variant``), as
    chip_smoke.py and kernel_ab build it, compiled once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.utils import kernel_ab
    src = kernel_ab.glue_clock_variant("kh", (_build.CSRC / "local_frame.cu").read_text(),
                                       "kh_clock")
    out = kernel_ab.OUT_DIR
    kernel_ab.OUT_DIR = tmp_path_factory.mktemp("kh_clock")
    try:
        return kernel_ab.build_all({"kh_clock": ("kh", src)}, lambda msg: None)["kh_clock"]
    finally:
        kernel_ab.OUT_DIR = out


@pytest.mark.parametrize("n", [600, 64])
def test_local_frame_kernel_and_its_clock_build(cuda, kh_clock_build, n):
    """Kernel (h)'s one cluster of 16 CTAs on a curved window, through the
    package's build and through its clock build: the chain's bits from
    both, and every CTA's thread 0 stamping each round's phases, its own
    rows' path parameters and the whole, CTA 0 alone its scan."""
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.ops import local_frame
    from mpc_mmd_tpu_torch.utils import kernel_ab
    x, y = kh_window("curved", 4000, n, "cuda")
    sw = tf.build_smoother(n, device="cuda")
    ref = tf.path_parameters(*tf.smooth_path(sw, x, y, 0.1))
    got = local_frame(sw, x, y, 0.1)
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    stamps = torch.zeros(4096 * kernel_ab.KC_CLOCK_SLOTS, dtype=torch.int64, device="cuda")
    assert kh_clock_build.mmd_glue_clock(stamps.data_ptr(), 1) == 0
    got = local_frame(sw, x, y, 0.1, lib=kh_clock_build)
    assert kh_clock_build.mmd_glue_clock(stamps.data_ptr(), 0) == 0
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    st = stamps.view(4096, kernel_ab.KC_CLOCK_SLOTS)
    regions = kernel_ab.CLOCK_REGIONS["kh_clock"]
    assert bool((st[:16, -1] > 0).all()) and bool((st[16:] == 0).all())
    for i, r in enumerate(regions):
        if r in kernel_ab.KH_ROUND_PHASES or r in ("staging", "path parameters"):
            assert bool((st[:16, i] > 0).all()), r
        elif r == "scan":
            assert int(st[0, i]) > 0 and bool((st[1:16, i] == 0).all()), r


@pytest.mark.parametrize("n", [65, 127, 515, 516, 601, 639])
def test_local_frame_kernel_at_every_width(cuda, n):
    """Kernel (h) at widths between ``kh_window``'s (cuBLAS's blocked and
    strided orders on both sides of 516 columns, a last CTA whose rows are
    not a whole number of units, the most path points it takes): bit-equal
    to the chain and to its twin at ten rounds."""
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.ops import local_frame
    from mpc_mmd_tpu_torch.ops.local_frame import local_frame_twin
    x, y = kh_window("circuit", 4000, n, "cuda")
    sw = tf.build_smoother(n, maxiter=10, device="cuda")
    got = local_frame(sw, x, y, 0.1)
    ref = tf.path_parameters(*tf.smooth_path(sw, x, y, 0.1))
    twin = local_frame_twin(sw, x, y, 0.1)
    for name, g, r, t in zip(got._fields, got, ref, twin):
        assert _same_bits(g, r), name
        assert _same_bits(t, r), name


@pytest.mark.parametrize("where", [("x", 37), ("y", 0), ("x", 599)])
def test_local_frame_kernel_propagates_a_nan_waypoint(cuda, where):
    """A NaN waypoint: kernel (h)'s outputs the chain's, NaN to NaN."""
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.ops import local_frame
    x, y = kh_window("curved", 4000, 600, "cuda")
    (x if where[0] == "x" else y)[where[1]] = float("nan")
    sw = tf.build_smoother(600, device="cuda")
    got = local_frame(sw, x, y, 0.1)
    ref = tf.path_parameters(*tf.smooth_path(sw, x, y, 0.1))
    assert all(_same_bits(g, r) for g, r in zip(got, ref))
    assert bool(got.x_path.isnan().any())


def test_local_frame_build_and_launch_failures_raise(cuda, monkeypatch, tmp_path):
    """The kernel's entry refusing a launch (a path shorter than it takes)
    and an entry that returns an error raise through the wrapper's check;
    the wrapper refuses a path past MAX_PATH; a build whose source does
    not compile raises."""
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.ops import _build, local_frame
    x, y = kh_window("curved", 0, 64, "cuda")
    sw = tf.build_smoother(64, device="cuda")
    out = torch.empty((6, 64), device="cuda")
    err = _build.library().mmd_local_frame(sw.kkt_inv.data_ptr(), x.data_ptr(), y.data_ptr(),
                                           out.data_ptr(), 10, 10, 0.1, _build.stream())
    assert err != 0
    with pytest.raises(RuntimeError, match="local_frame"):
        _build.check(err, "local_frame")

    class Failing:
        def mmd_local_frame(self, *args):
            return 1
    with pytest.raises(RuntimeError, match="local_frame"):
        local_frame(sw, x, y, 0.1, lib=Failing())
    with pytest.raises(ValueError):
        local_frame(tf.build_smoother(700, device="cuda"), torch.zeros(700, device="cuda"),
                    torch.zeros(700, device="cuda"))
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


def test_obstacle_form_trajectories_equal_the_chains(cuda):
    """Kernel (g)'s obstacle form with the horizon's times on a closed-loop
    frame and on adversarial positions: the five conversions and x_obs,
    y_obs bit-equal to global_to_frenet_obstacle and
    constant_velocity_obstacles on the card."""
    from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_obstacle
    from mpc_mmd_tpu_torch.ops import frenet_obstacles
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case, kg_closedloop
    cfg = _workload("path_d")
    (frame, _, _), obs = kg_closedloop(cuda, cfg)
    tot = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device="cuda")
    runs = [(frame, obs)]
    for case in ("far_off_the_path", "non_finite_query", "ragged_sizes"):
        f, x, y = kg_case(case, "cuda")
        m = x.shape[0]
        runs.append((f, torch.stack((x, y, 3.0 * torch.randn(m, device="cuda", generator=cuda),
                                     torch.randn(m, device="cuda", generator=cuda),
                                     torch.rand(m, device="cuda", generator=cuda)), dim=1)))
    for f, o in runs:
        before = frenet_obstacles.launches
        got = frenet_obstacles(f, o, tot_time=tot)
        assert frenet_obstacles.launches == before + 1
        conv = global_to_frenet_obstacle(f, *o.unbind(1))
        ref = tuple(conv) + constant_velocity_obstacles(*conv, tot)[:2]
        assert len(got) == 7 and all(_same_bits(g, r) for g, r in zip(got, ref))


def test_local_problem_on_the_card_equals_its_chains(cuda):
    """closedloop.local_problem on the card: one launch each of (h) and
    (g)'s obstacle form, and its frame, trajectories and state the bits of
    the chains they replace."""
    from mpc_mmd_tpu_torch import closedloop as cl
    from mpc_mmd_tpu_torch import frenet as tf
    from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
    from mpc_mmd_tpu_torch.ops import frenet_obstacles, local_frame
    cfg = _onroad("mmd_opt")
    plant = cl.SyntheticPlant(cfg, cl.make_route("curved"),
                              ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5)),
                              obstacle_speed=1.0)
    plant.step(0.5, 0.02)
    tot = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device="cuda")
    sw = tf.build_smoother(cfg.frenet.num_path, device="cuda")
    counts = (local_frame.launches, frenet_obstacles.launches)
    frame, x_obs, y_obs, init = cl.local_problem(cfg, plant, sw, tot)
    assert (local_frame.launches, frenet_obstacles.launches) == (counts[0] + 1, counts[1] + 1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    x_e, y_e, v_e, psi_e, psidot_e = plant.state
    x_wp, y_wp, _ = tf.waypoint_window(plant.spline, x_e, y_e, cfg.frenet.lookahead,
                                       cfg.frenet.num_path)
    ref = tf.path_parameters(*tf.smooth_path(sw, f32(x_wp - x_e), f32(y_wp - y_e),
                                             cfg.frenet.smooth_threshold))
    obs = cl.perceive_obstacles(cfg, plant, (x_e, y_e), psi_e).copy()
    obs[:, 0] -= x_e
    obs[:, 1] -= y_e
    conv = tf.global_to_frenet_obstacle(ref, *f32(obs[:, :5]).unbind(1))
    xo, yo, _ = constant_velocity_obstacles(*conv, tot)
    assert all(_same_bits(g, r) for g, r in zip(frame, ref))
    assert _same_bits(x_obs, xo) and _same_bits(y_obs, yo)
    assert torch.equal(init, f32([0.0, 0.0, v_e, plant.vdot, psi_e, psidot_e]))
