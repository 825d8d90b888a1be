"""K2: batched tiny equality-constrained QP (CUDA source ``csrc/eq_qp.cu``).

Replaces ``mpc_mmd_tpu/ops/qp_pallas.py::eq_qp_solve_pallas`` and, with it,
the body of the lane-major entry ``eq_qp_solve_pallas_t`` (that layout is
not ported).  On the solve paths it solves the reduced-set weight QP of
every inner-CEM sample: 3,648 to 10,000 systems of n = 10 a call on the
straight-road paths, and 8,900 or 10,000 systems of n = 4 on the on-road
path (num_reduced 4).

One thread solves one system by the Pallas body's unrolled Cholesky, step
for step.  On the card a block of 64 systems (two warps) copies its
contiguous C and r into shared memory with cp.async and writes b back as
one span, so the loads and stores coalesce and the blocks spread over the
SMs.  What is left is the staging, each thread's chain of dependent
multiply-adds and the launch; the note at the top of the CUDA source has
the numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ..linalg import eq_qp_solve as eq_qp_solve_plain

SIZES = (4, 10)  # the n the kernel is instantiated for


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
        raise ValueError(f"eq_qp_solve: kernel built for n in {SIZES}, got {n}")
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
