"""Kernel Gram matrices and MMD against the all-zeros target set.

Counterpart of ``mpc_mmd_tpu/kernels.py``: ``pairwise_l1``,
``pairwise_l2sq``, the laplace, gaussian and Matern-5/2 kernels,
``kernel_of`` and ``mmd_vs_zero``.  Every kernel is an elementwise map of
pairwise distances computed once, so callers keep the L1 distances and,
for the gaussian and matern52 kinds, the squared L2 ones.
"""

from __future__ import annotations

import math

import torch

from .config import KERNEL_KINDS

__all__ = ["KERNEL_KINDS", "gaussian_kernel", "kernel_of", "laplace_kernel",
           "matern52_kernel", "mmd_vs_zero", "pairwise_l1", "pairwise_l2sq"]


def pairwise_l1(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, F) x (..., n, F) -> (..., m, n) pairwise L1 distances."""
    return torch.sum(torch.abs(A[..., :, None, :] - B[..., None, :, :]), dim=-1)


def pairwise_l2sq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, F) x (..., n, F) -> (..., m, n) squared L2 distances.

    The matmul expansion |a|^2 + |b|^2 - 2 a.b clamped at 0, as the JAX
    package computes it; direct squared differences round differently.
    """
    aa = torch.sum(A * A, dim=-1)
    bb = torch.sum(B * B, dim=-1)
    ab = torch.matmul(A, B.transpose(-1, -2))
    return torch.clamp(aa[..., :, None] + bb[..., None, :] - 2.0 * ab, min=0.0)


def laplace_kernel(dists_l1: torch.Tensor, sigma) -> torch.Tensor:
    """exp(-d / sigma)."""
    return torch.exp(-dists_l1 / sigma)


def gaussian_kernel(dists_l2sq: torch.Tensor, sigma) -> torch.Tensor:
    """exp(-d^2 / (2 sigma^2))."""
    return torch.exp(-dists_l2sq / (2.0 * sigma ** 2))


def matern52_kernel(dists_l1: torch.Tensor, dists_l2sq: torch.Tensor,
                    sigma) -> torch.Tensor:
    """Matern-5/2 with the L1 radius, as the JAX package writes it."""
    r1 = math.sqrt(5.0) * dists_l1 / sigma
    return (1.0 + r1 + 5.0 * dists_l2sq / (3.0 * sigma ** 2)) * torch.exp(-r1)


def kernel_of(kind: str, sigma, d1=None, d2sq=None) -> torch.Tensor:
    """The configured kernel (``RiskConfig.kernel``) from the L1 distances
    ``d1`` and, for the gaussian and matern52 kinds, the squared L2 ones
    ``d2sq``; ``sigma`` a float or broadcast against the distances."""
    if kind == "laplace":
        return laplace_kernel(d1, sigma)
    if kind == "gaussian":
        return gaussian_kernel(d2sq, sigma)
    if kind == "matern52":
        return matern52_kernel(d1, d2sq, sigma)
    raise ValueError(f"unknown kernel kind {kind!r} (expected one of "
                     f"{KERNEL_KINDS})")


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
    quad = torch.einsum("...i,...ij,...j->...", beta, K_aa, beta)
    d_ab = torch.abs(cost)
    cross = torch.sum(
        beta * kernel_of(kind, sigma[..., None] if batched else sigma,
                         d_ab, d_ab * d_ab),
        dim=-1)
    return ker_wt * (quad - 2.0 * cross)
