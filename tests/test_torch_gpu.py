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
1e-5 + atol 1e-6 (sums taken in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_mmd_tpu_torch import Solver, dynamic_workload, fastrt_workload
from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
from mpc_mmd_tpu_torch.kernels import pairwise_l2sq
from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
from mpc_mmd_tpu_torch.linalg import scenario_mm
from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, record_solve_draws
from mpc_mmd_tpu_torch.ops import (eq_qp_solve, fused_rollout, topk_indices,
                                   topk_kernel_matrices, topk_onehot)
from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain, topk_onehot_plain
from mpc_mmd_tpu_torch.ops.topk_kernel import topk_kernel_matrices_plain
from mpc_mmd_tpu_torch.sampling import _cholesky

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
    x = torch.randn(4, 129, device="cuda", generator=cuda)
    with pytest.raises(ValueError):
        topk_indices(x, 3)                                 # wider than 128
    with pytest.raises(ValueError):
        topk_indices(x[:, :100].t(), 3)                    # not contiguous
    with pytest.raises(TypeError):
        topk_indices(x.double(), 3)
    C = torch.eye(5, device="cuda").expand(3, 5, 5).contiguous()
    with pytest.raises(ValueError):
        eq_qp_solve(C, torch.ones(3, 5, device="cuda"))    # n not built
    with pytest.raises(ValueError):
        eq_qp_solve(C[:, :4, :4].contiguous(), torch.ones(3, 4))   # mixed devices


def _selection_inputs(gen, C, S, M):
    samples = torch.randn(C, S, M + 1, device="cuda", generator=gen)
    samples[..., M] = samples[..., M].abs() * 3 + 0.01
    samples[0, 1, 7] = float("nan")                      # NaN lane: index M
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
    samples = torch.randn(4, 8, 130, device="cuda", generator=cuda)
    D = torch.rand(4, 129, 129, device="cuda", generator=cuda)
    with pytest.raises(ValueError):
        topk_kernel_matrices(samples, D, 5)                 # M > 128
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


def test_dynamic_fused_outer_iteration_cuda_matches_cpu(cuda, monkeypatch):
    """Path A (dynamic workload, Beta noise, fused selection) for one outer
    iteration: the CPU run records its Beta draws and the card replays them."""
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
    before = topk_kernel_matrices.launches
    g = Solver(cfg, device="cuda", noise=FixedNoise(arrays, "cuda")).solve(0, *args)
    assert topk_kernel_matrices.launches == before + cfg.beta_cem.maxiter
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
    """One outer iteration of the on-road mmd_opt solve (K1, K2 and K4 with
    a state per lane, 16 mother rollouts from 16 noisy initial states) on
    the card against the CPU with identical draws and the same frame: the
    controls within 1e-3."""
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
    before = fused_rollout.launches
    g = FrenetSolver(cfg, device="cuda", noise=FixedNoise(arrays, "cuda")).solve(0, *args)
    assert fused_rollout.launches == before + 1
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
    counts = lambda: [f.launches for f in (topk_indices, eq_qp_solve, fused_rollout)]
    before = counts()
    one = solver.solve(5, init, mean, cov, xs[0], ys[0], 15.0)
    per_solve = [b - a for a, b in zip(before, counts())]
    before = counts()
    batch = solver.solve_batch([5, 6, 7], init, mean, cov, xs, ys, 15.0)
    assert [b - a for a, b in zip(before, counts())] == per_solve
    assert per_solve[0] > 0 and per_solve[2] == cfg.cem.maxiter_cem
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


# The shared-weight products of the fastrt (64 candidates), dynamic and
# on-road (100) solves, (rows of one scenario, K, N): the guess QP, the
# projection and its KKT solves, and the refit of the mother rollouts.
PRODUCT_SHAPES = [(R, K, N) for R in (64, 100) for K, N in (
    (4, 11), (11, 100), (11, 198), (14, 14), (15, 15), (100, 11), (198, 11))] + [
    (6400, 50, 11), (6400, 11, 11), (10000, 50, 11), (10000, 11, 11),
    (1600, 50, 11), (1600, 11, 11)]


@pytest.mark.parametrize("rows,K,N", PRODUCT_SHAPES)
def test_scenario_mm_gives_a_scenario_its_bits_in_any_chunk(cuda, rows, K, N):
    """Each scenario's rows of ``scenario_mm`` over 2-16 scenarios equal
    that scenario's product alone, bit for bit, and the product is a GEMM's
    to float32 round-off."""
    w = torch.randn(K, N, device="cuda", generator=cuda)
    x = torch.randn(16 * rows, K, device="cuda", generator=cuda)
    alone = [scenario_mm(x[i * rows:(i + 1) * rows], w) for i in range(16)]
    for n in (2, 3, 4, 5, 8, 16):
        out = scenario_mm(x[:n * rows], w, n)
        for i in range(n):
            assert torch.equal(out[i * rows:(i + 1) * rows], alone[i]), (n, i)
    torch.testing.assert_close(alone[0], x[:rows] @ w, rtol=1e-5, atol=1e-4)


def test_outer_cem_cholesky_gives_a_scenario_its_bits_in_any_chunk(cuda):
    """The outer CEM's factors of 1-8 covariances at once equal each
    factored alone, bit for bit; a covariance that is not positive definite
    gives NaN."""
    L = torch.randn(8, 8, 8, device="cuda", generator=cuda)
    A = L @ L.mT + 0.1 * torch.eye(8, device="cuda")
    alone = [_cholesky(A[i]) for i in range(8)]
    torch.testing.assert_close(alone[0], torch.linalg.cholesky(A[0]), rtol=1e-5,
                               atol=1e-5)
    for n in range(1, 9):
        out = _cholesky(A[:n])
        for i in range(n):
            assert torch.equal(out[i], alone[i]), (n, i)
    bad = torch.stack((A[0], -torch.eye(8, device="cuda")))
    out = _cholesky(bad)
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1]).all())


@pytest.mark.parametrize("S,n_el,M1,nb", [(57, 7, 101, 64), (89, 11, 101, 100),
                                          (89, 11, 17, 100)])
def test_inner_resample_gives_a_candidate_its_bits_in_any_chunk(cuda, S, n_el, M1, nb):
    """The inner CEM's resample ``A_t @ elites`` over the candidates of
    1-8 scenarios: each scenario's candidates equal them alone."""
    A = torch.randn(S, n_el, device="cuda", generator=cuda)
    E = torch.randn(8 * nb, n_el, M1, device="cuda", generator=cuda)
    alone = [A @ E[i * nb:(i + 1) * nb] for i in range(8)]
    for n in (2, 3, 4, 8):
        out = A @ E[:n * nb]
        for i in range(n):
            assert torch.equal(out[i * nb:(i + 1) * nb], alone[i]), (n, i)


@pytest.mark.parametrize("M,nb", [(100, 64), (100, 100), (16, 100)])
def test_pairwise_l2sq_gives_a_candidate_its_bits_in_any_chunk(cuda, M, nb):
    """``pairwise_l2sq`` of the refitted features (C, M, 22) of 1-8
    scenarios' candidates: each scenario's block equals it alone."""
    F = torch.randn(8 * nb, M, 22, device="cuda", generator=cuda)
    alone = [pairwise_l2sq(F[i * nb:(i + 1) * nb], F[i * nb:(i + 1) * nb])
             for i in range(8)]
    for n in (2, 3, 4, 8):
        out = pairwise_l2sq(F[:n * nb], F[:n * nb])
        for i in range(n):
            assert torch.equal(out[i * nb:(i + 1) * nb], alone[i]), (n, i)
