"""The port's CUDA kernels against their plain twins, on a CUDA card.

Marked ``gpu``: without a card every test here skips.  On a machine with
one, and without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py imports JAX).  This file
imports no JAX.  Tolerances: top-k indices exact; QP within rtol 1e-4 +
atol 1e-5 of the twin in float64; rollout within atol 1e-4 of the twin on
the card (accurate tanf/sinf/cosf, FMA contraction).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_mmd_tpu_torch import Solver, fastrt_workload
from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise
from mpc_mmd_tpu_torch.ops import eq_qp_solve, fused_rollout, topk_indices
from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape,k,kw", [
    ((64, 57, 101), 10, dict(absolute=True, slice_to=100)),
    ((5, 128), 20, {}),
    ((3, 7, 33), 33, dict(absolute=True)),
    ((64, 64), 7, {}),
    ((1, 1, 3), 5, {}),                                   # k > width
])
def test_topk_kernel_matches_twin(cuda, shape, k, kw):
    x = torch.randn(shape, device="cuda", generator=cuda)
    x.view(-1, shape[-1])[0] = float("nan")
    x.view(-1, shape[-1])[-1, ::2] = float("nan")
    for t in (x, torch.round(x * 2) / 2):
        before = topk_indices.launches
        got = topk_indices(t, k, **kw)
        assert topk_indices.launches == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, topk_indices_plain(t, k, **kw))


@pytest.mark.parametrize("n", [4, 10])
def test_eq_qp_kernel_matches_float64_twin(cuda, n):
    f = torch.randn(64, 57, n, 22, device="cuda", generator=cuda)
    d = (f[..., :, None, :] - f[..., None, :, :]).abs().sum(-1)
    sigma = torch.rand(64, 57, 1, 1, device="cuda", generator=cuda) * 10 + 0.01
    K = torch.exp(-d / sigma)
    C = (K + 0.05 * torch.eye(n, device="cuda")).contiguous()
    r = (K.sum(-1) / 100.0).contiguous()
    b, mu = eq_qp_solve(C, r)
    b64, mu64 = qp_plain(C.double(), r.double())
    torch.testing.assert_close(b.double(), b64, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mu.double(), mu64, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("per_lane", [False, True])
def test_rollout_kernel_matches_twin(cuda, per_lane):
    L, T = 1000, 50
    acc = 1.0 + 0.5 * torch.randn(L, T, device="cuda", generator=cuda)
    steer = 0.1 * torch.randn(L, T, device="cuda", generator=cuda)
    s0 = (torch.randn(L, 5, device="cuda", generator=cuda) if per_lane
          else torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device="cuda"))
    x, y = fused_rollout(acc, steer, s0, 0.15, 2.5)
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


def test_one_outer_iteration_cuda_matches_cpu(cuda):
    cfg = fastrt_workload(num_reduced=4, num_obs=2)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=1))
    c, bc = cfg.cem, cfg.beta_cem
    src = TorchNoise(torch.Generator(), "cpu")
    inner = src.inner_cem(bc.num_samples_cem, cfg.risk.num_mother,
                          bc.num_ellite, bc.maxiter)
    eps = src.rollout_eps(0, 0, 4, cfg.horizon.num_prime)
    arrays = {"initial_z": src.initial_z(c.num_batch, 8), "samples0": inner.samples0,
              "u": inner.u, "z": inner.z, "eps_acc": eps[0][None],
              "eps_steer": eps[1][None], "eps_const": eps[2][None],
              "cem_z": src.cem_z(0, 0, c.num_batch - c.ellite_num, 8)[None]}
    arrays = {k: v.numpy() for k, v in arrays.items()}
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
