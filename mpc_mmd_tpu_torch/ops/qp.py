"""K2: batched tiny equality-constrained QP (CUDA source ``csrc/eq_qp.cu``).

Replaces ``mpc_mmd_tpu/ops/qp_pallas.py``: ``eq_qp_solve`` the row-major
entry ``eq_qp_solve_pallas`` and ``eq_qp_solve_t`` the lane-major
``eq_qp_solve_pallas_t``, one body for both.  On the solve paths K2 solves
the reduced-set weight QP of every inner-CEM sample, n = num_reduced:
3,648 to 10,000 systems of n = 10 a call on the straight-road paths
(8,900 and 10,000 at the record's N = 5 and 15 cells), 8,900 or 10,000 of
n = 4 on the on-road path; the lane-major entry the same counts under the
"xt" selection.  Both are built for every n in :data:`SIZES`, 2 ... 16,
the range the Pallas body's docstring gives.

One thread solves one system by the Pallas body's unrolled Cholesky, step
for step.  On the card the row-major kernel's block of 64 systems (two
warps) copies its contiguous C and r into shared memory with cp.async and
writes b back as one span, so the loads and stores coalesce and the blocks
spread over the SMs; the lane-major kernel reads each element of 32
consecutive systems as 32 consecutive words, coalesced as they lie.  What
is left is each thread's chain of dependent multiply-adds and the launch;
the note at the top of the CUDA source has the numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..linalg import eq_qp_solve as eq_qp_solve_plain

SIZES = range(2, 17)  # the n the kernels are instantiated for


def eq_qp_solve(C: torch.Tensor, r: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1, C SPD; returns (b, mu).

    C (..., n, n), r (..., n).  A CPU tensor takes the plain twin
    (``linalg.eq_qp_solve``); a CUDA tensor launches the kernel
    (float32, contiguous, n in :data:`SIZES`).
    """
    n = C.shape[-1]
    if C.shape[-2] != n or r.shape != C.shape[:-1]:
        raise ValueError(f"eq_qp_solve: C {tuple(C.shape)} and r "
                         f"{tuple(r.shape)} do not match")
    if C.device.type == "cpu" and r.device.type == "cpu":
        return eq_qp_solve_plain(C, r)
    _build.require_cuda_f32("eq_qp_solve", C, r)
    if n not in SIZES:
        raise ValueError(f"eq_qp_solve: kernel built for n in {SIZES.start} ... "
                         f"{SIZES.stop - 1}, got {n}")
    batch = r.numel() // n
    b = torch.empty_like(r)
    mu = torch.empty(r.shape[:-1], dtype=r.dtype, device=r.device)
    err = _build.library().mmd_eq_qp_solve(
        C.data_ptr(), r.data_ptr(), b.data_ptr(), mu.data_ptr(), batch, n,
        _build.stream())
    _build.check(err, "eq_qp_solve")
    eq_qp_solve.launches += 1
    return b, mu


eq_qp_solve.launches = 0


def eq_qp_solve_t_plain(C_t: torch.Tensor, r_t: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane-major twin: the row-major twin on the transposed operands,
    copied row-major (the twin's sums take their order from the layout);
    returns b_t (n, B) contiguous and mu (B,)."""
    n, B = r_t.shape
    b, mu = eq_qp_solve_plain(C_t.T.contiguous().view(B, n, n), r_t.T.contiguous())
    return b.T.contiguous(), mu


def eq_qp_solve_t(C_t: torch.Tensor, r_t: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The QP of :func:`eq_qp_solve` on lane-major operands: C_t (n*n, B)
    with row i*n+j = C[..., i, j], r_t (n, B); returns (b_t (n, B), mu (B,)).

    A CPU tensor takes :func:`eq_qp_solve_t_plain`; a CUDA tensor launches
    the kernel (float32, contiguous, n in :data:`SIZES`).
    """
    if r_t.dim() != 2 or C_t.shape != (r_t.shape[0] ** 2, r_t.shape[1]):
        raise ValueError(f"eq_qp_solve_t: C_t {tuple(C_t.shape)} and r_t "
                         f"{tuple(r_t.shape)} do not match")
    if C_t.device.type == "cpu" and r_t.device.type == "cpu":
        return eq_qp_solve_t_plain(C_t, r_t)
    _build.require_cuda_f32("eq_qp_solve_t", C_t, r_t)
    n, batch = r_t.shape
    if n not in SIZES:
        raise ValueError(f"eq_qp_solve_t: kernel built for n in {SIZES.start} ... "
                         f"{SIZES.stop - 1}, got {n}")
    b_t = torch.empty_like(r_t)
    mu = torch.empty(batch, dtype=r_t.dtype, device=r_t.device)
    err = _build.library().mmd_eq_qp_solve_t(
        C_t.data_ptr(), r_t.data_ptr(), b_t.data_ptr(), mu.data_ptr(), batch, n,
        _build.stream())
    _build.check(err, "eq_qp_solve_t")
    eq_qp_solve_t.launches += 1
    return b_t, mu


eq_qp_solve_t.launches = 0
