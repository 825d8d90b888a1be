"""Batched tiny equality-constrained QP by block elimination.

Counterpart of ``mpc_mmd_tpu/linalg.py``; :func:`eq_qp_solve` is the plain
twin of the K2 kernel (``ops/qp.py``).  The Cholesky factorisation and both
substitutions are unrolled over the small static dimension, one batched
vector operation per scalar step.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD matrices (..., n, n)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = torch.sum(L[..., j, :j] ** 2, dim=-1) if j else 0.0
        d = torch.sqrt(A[..., j, j] - s)
        L[..., j, j] = d
        if j + 1 < n:
            cross = (torch.einsum("...ik,...k->...i", L[..., j + 1:, :j],
                                  L[..., j, :j]) if j else 0.0)
            L[..., j + 1:, j] = (A[..., j + 1:, j] - cross) / d[..., None]
    return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b; L (..., n, n), b (..., n)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        s = (torch.einsum("...k,...k->...", L[..., i, :i], y[..., :i])
             if i else 0.0)
        y[..., i] = (b[..., i] - s) / L[..., i, i]
    return y


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Backward substitution L^T x = y."""
    n = L.shape[-1]
    x = torch.zeros_like(y)
    for i in range(n - 1, -1, -1):
        s = (torch.einsum("...k,...k->...", L[..., i + 1:, i], x[..., i + 1:])
             if i + 1 < n else 0.0)
        x[..., i] = (y[..., i] - s) / L[..., i, i]
    return x


def eq_qp_solve(C: torch.Tensor, r: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1, C SPD (batched).

    z = C^-1 r, w = C^-1 1, mu = (sum z - 1) / sum w, b = z - mu w.
    Returns (b (..., n), mu (...)).
    """
    L = cholesky_small(C)
    z = solve_upper_t(L, solve_lower(L, r))
    w = solve_upper_t(L, solve_lower(L, torch.ones_like(r)))
    mu = (torch.sum(z, dim=-1) - 1.0) / torch.sum(w, dim=-1)
    return z - mu[..., None] * w, mu
