"""Kernel Gram matrices and MMD against the all-zeros target set.

Counterpart of ``mpc_mmd_tpu/kernels.py``: ``pairwise_l1``,
``pairwise_l2sq``, the laplace, gaussian and Matern-5/2 kernels,
``kernel_of``, ``mmd_vs_zero`` and its row-blocked form
``blockwise_mmd_vs_zero``.  Every kernel is an elementwise map of
pairwise distances computed once, so callers keep the L1 distances and,
for the gaussian and matern52 kinds, the squared L2 ones.
"""

from __future__ import annotations

import math

import torch

from .config import KERNEL_KINDS

__all__ = ["KERNEL_KINDS", "blockwise_mmd_vs_zero", "gaussian_kernel",
           "kernel_of", "laplace_kernel", "matern52_kernel", "mmd_vs_zero",
           "pairwise_l1", "pairwise_l2sq"]


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
    quad = torch.sum(beta[..., :, None] * K_aa * beta[..., None, :], dim=(-2, -1))
    d_ab = torch.abs(cost)
    cross = torch.sum(
        beta * kernel_of(kind, sigma[..., None] if batched else sigma,
                         d_ab, d_ab * d_ab),
        dim=-1)
    return ker_wt * (quad - 2.0 * cross)


def blockwise_mmd_vs_zero(beta: torch.Tensor, cost: torch.Tensor, sigma,
                          ker_wt: float, block: int = 1024,
                          kind: str = "laplace") -> torch.Tensor:
    """:func:`mmd_vs_zero` of large sample sets without the (n, n) Gram
    matrix: the quadratic term beta^T K beta accumulates over row blocks of
    ``block`` samples, so memory is O(block n).  Exact.

    beta, cost (..., n) of one shape; sigma a float or a tensor that
    broadcasts to the leading shape (with 1-d samples, a batch of
    bandwidths gives one MMD each, as ``mmd_vs_zero`` does).  The samples
    are padded with zero weights to a whole number of blocks.  No caller in
    either package.
    """
    if beta.shape != cost.shape:
        raise ValueError(f"beta {tuple(beta.shape)} and cost "
                         f"{tuple(cost.shape)} must share a shape")
    batched = torch.is_tensor(sigma) and sigma.dim() > 0
    if cost.dim() == 1 and batched:
        beta = beta.expand(sigma.shape + beta.shape)
        cost = cost.expand(sigma.shape + cost.shape)
    lead, n = cost.shape[:-1], cost.shape[-1]
    b2, c2 = beta.reshape(-1, n), cost.reshape(-1, n)
    sig = sigma.expand(lead).reshape(-1, 1, 1) if batched else sigma
    pad = (-n) % block
    if pad:
        b2 = torch.cat((b2, b2.new_zeros(b2.shape[0], pad)), dim=1)
        c2 = torch.cat((c2, c2.new_zeros(c2.shape[0], pad)), dim=1)
    quad = b2.new_zeros(b2.shape[0])
    for lo in range(0, n + pad, block):
        d = torch.abs(c2[:, lo:lo + block, None] - c2[:, None, :])   # (B, block, n)
        K_rows = kernel_of(kind, sig, d, d * d)
        quad = quad + (b2[:, None, lo:lo + block] @ (K_rows @ b2[:, :, None]))[:, 0, 0]
    d_ab = torch.abs(c2)
    cross = torch.sum(b2 * kernel_of(kind, sig[..., 0] if batched else sig,
                                     d_ab, d_ab * d_ab), dim=-1)
    return (ker_wt * (quad - 2.0 * cross)).reshape(lead)
