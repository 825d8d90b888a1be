"""Batched tiny equality-constrained QP by block elimination.

Counterpart of ``mpc_mmd_tpu/linalg.py``; :func:`eq_qp_solve` is the plain
twin of the K2 kernel (``ops/qp.py``).  The Cholesky factorisation and both
substitutions are unrolled over the small static dimension, one batched
vector operation per scalar step.

A scenario solved in a chunk should come out with the bits it has alone,
and a GEMM library picks its kernel, and with it the order of a row's sum,
by the shape of the whole call: on the H100 cuBLAS gives a row other bits
at another row count (K = 198 already between 64 and 256 rows) and in a
batch of one than in a batch of several.  :func:`scenario_mm` keeps every
call at one scenario's shape; :func:`matmul_rows`, an elementwise product
and a sum, serves the per-scenario products of the outer CEM.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def scenario_mm(x: torch.Tensor, w: torch.Tensor, scenarios: int = 1
                ) -> torch.Tensor:
    """x @ w for rows x (..., K) (leading axes flattened) that are
    ``scenarios`` equal blocks, the rows of one scenario after another,
    and w (K, N) shared: one batched
    GEMM over each scenario's rows split into two halves (into its smallest
    number of equal parts above one where the count is odd).

    Every call then has the half-block's shape and a batch of at least two
    (cuBLAS takes another kernel for a batch of one), however many
    scenarios share it.  On the H100 a scenario's rows came out with the
    same bits at 1 to 16 scenarios a call at every product shape of the
    fastrt, dynamic and on-road solves (two halves; with four quarters, 16
    scenarios at K = 198 differed), so this is a property checked at those
    shapes, not one the library promises.
    """
    lead, k = x.shape[:-1], x.shape[-1]
    rows = math.prod(lead)
    per = rows // scenarios
    parts = next((d for d in range(2, math.isqrt(per) + 1) if per % d == 0),
                 max(per, 1))
    b = scenarios * parts
    out = torch.bmm(x.reshape(b, rows // b, k), w.expand(b, *w.shape))
    return out.reshape(*lead, w.shape[-1])


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as an elementwise product and a sum over the shared axis: a
    row's order of summation is set by its own shapes, whatever the batch.

    x (..., K); w (K, N), or (..., K, N) with its leading axes aligned to
    x's (a batch of matrices, one per leading index).  Returns (..., N).
    """
    return torch.sum(x[..., :, None] * w, dim=-2)


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD matrices (..., n, n); a matrix that is
    not positive definite gives NaN from its first failing column on."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        s = torch.sum(L[..., j, :j] ** 2, dim=-1) if j else 0.0
        d = torch.sqrt(A[..., j, j] - s)
        L[..., j, j] = d
        if j + 1 < n:
            cross = (torch.sum(L[..., j + 1:, :j] * L[..., j, None, :j], dim=-1)
                     if j else 0.0)
            L[..., j + 1:, j] = (A[..., j + 1:, j] - cross) / d[..., None]
    return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L y = b; L (..., n, n), b (..., n)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        s = torch.sum(L[..., i, :i] * y[..., :i], dim=-1) if i else 0.0
        y[..., i] = (b[..., i] - s) / L[..., i, i]
    return y


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Backward substitution L^T x = y."""
    n = L.shape[-1]
    x = torch.zeros_like(y)
    for i in range(n - 1, -1, -1):
        s = (torch.sum(L[..., i + 1:, i] * x[..., i + 1:], dim=-1)
             if i + 1 < n else 0.0)
        x[..., i] = (y[..., i] - s) / L[..., i, i]
    return x


def cho_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A x = b given the lower Cholesky factor L of SPD A (batched)."""
    return solve_upper_t(L, solve_lower(L, b))


def eq_qp_solve(C: torch.Tensor, r: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1, C SPD (batched).

    z = C^-1 r, w = C^-1 1, mu = (sum z - 1) / sum w, b = z - mu w.
    Returns (b (..., n), mu (...)).
    """
    L = cholesky_small(C)
    z = cho_solve_small(L, r)
    w = cho_solve_small(L, torch.ones_like(r))
    mu = (torch.sum(z, dim=-1) - 1.0) / torch.sum(w, dim=-1)
    return z - mu[..., None] * w, mu
