# Frozen copy of mpc_mmd_tpu_torch/kernels.py (commit eb91b04) cut to what
# the cells run: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""The laplace kernel and MMD against the all-zeros target set.

Counterpart of ``pairwise_l1``, the laplace kernel, ``kernel_of`` and
``mmd_vs_zero`` in ``mpc_mmd_tpu/kernels.py`` (the gaussian and
Matern-5/2 kernels are the port's).  The kernel is an elementwise map of
the L1 distances, computed once.
"""

from __future__ import annotations

import torch


def pairwise_l1(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, F) x (..., n, F) -> (..., m, n) pairwise L1 distances."""
    return torch.sum(torch.abs(A[..., :, None, :] - B[..., None, :, :]), dim=-1)


def _laplace(kind: str) -> None:
    if kind != "laplace":
        raise NotImplementedError(f"the reference has the laplace kernel only, got {kind!r}")


def distance_matrices(cx: torch.Tensor, cy: torch.Tensor, kind: str):
    """(D, None): the L1 distances of the features [cx | cy] (..., m, 2
    nvar); the laplace kernel reads only D."""
    _laplace(kind)
    feats = torch.cat((cx, cy), dim=-1)
    return pairwise_l1(feats, feats), None


def laplace_kernel(dists_l1: torch.Tensor, sigma) -> torch.Tensor:
    """exp(-d / sigma)."""
    return torch.exp(-dists_l1 / sigma)


def kernel_of(kind: str, sigma, d1=None, d2sq=None) -> torch.Tensor:
    """The configured kernel (``RiskConfig.kernel``, laplace) from the L1
    distances ``d1``; ``sigma`` a float or broadcast against them."""
    _laplace(kind)
    return laplace_kernel(d1, sigma)


def mmd_vs_zero(beta: torch.Tensor, cost: torch.Tensor, sigma,
                ker_wt: float, kind: str = "laplace") -> torch.Tensor:
    """ker_wt * (beta^T K_aa beta - 2 beta . k(c, 0)) of weighted scalar samples.

    beta, cost: (..., k); sigma a float or (...,).  Returns (...).  The
    samples are scalars, so the squared L2 distance is the squared L1 one.
    """
    batched = torch.is_tensor(sigma) and sigma.dim() > 0
    d_aa = torch.abs(cost[..., :, None] - cost[..., None, :])
    K_aa = kernel_of(kind, sigma[..., None, None] if batched else sigma,
                     d_aa, d_aa * d_aa)
    quad = torch.sum(beta[..., :, None] * K_aa * beta[..., None, :], dim=(-2, -1))
    d_ab = torch.abs(cost)
    cross = torch.sum(
        beta * kernel_of(kind, sigma[..., None] if batched else sigma,
                         d_ab, d_ab * d_ab),
        dim=-1)
    return ker_wt * (quad - 2.0 * cross)


