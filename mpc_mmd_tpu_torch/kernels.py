"""Laplace kernel and MMD against the all-zeros target set.

Counterpart of ``mpc_mmd_tpu/kernels.py`` (``pairwise_l1``,
``laplace_kernel``, ``kernel_of``, ``mmd_vs_zero``) for the one kernel the
port has.
"""

from __future__ import annotations

import torch


def pairwise_l1(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., m, F) x (..., n, F) -> (..., m, n) pairwise L1 distances."""
    return torch.sum(torch.abs(A[..., :, None, :] - B[..., None, :, :]), dim=-1)


def laplace_kernel(dists_l1: torch.Tensor, sigma) -> torch.Tensor:
    """exp(-d / sigma)."""
    return torch.exp(-dists_l1 / sigma)


def kernel_of(kind: str, sigma, d1: torch.Tensor) -> torch.Tensor:
    """The configured kernel from L1 distances (laplace only)."""
    if kind != "laplace":
        raise NotImplementedError(
            f"the PyTorch port has only the laplace kernel, got {kind!r}")
    return laplace_kernel(d1, sigma)


def mmd_vs_zero(beta: torch.Tensor, cost: torch.Tensor, sigma,
                ker_wt: float, kind: str = "laplace") -> torch.Tensor:
    """ker_wt * (beta^T K_aa beta - 2 beta . k(c, 0)) of weighted scalar samples.

    beta, cost: (..., k); sigma a float or (...,).  Returns (...).
    """
    batched = torch.is_tensor(sigma) and sigma.dim() > 0
    d_aa = torch.abs(cost[..., :, None] - cost[..., None, :])
    K_aa = kernel_of(kind, sigma[..., None, None] if batched else sigma, d_aa)
    quad = torch.einsum("...i,...ij,...j->...", beta, K_aa, beta)
    d_ab = torch.abs(cost)
    cross = torch.sum(
        beta * kernel_of(kind, sigma[..., None] if batched else sigma, d_ab),
        dim=-1)
    return ker_wt * (quad - 2.0 * cross)
