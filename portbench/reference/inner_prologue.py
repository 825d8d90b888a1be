# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/inner_prologue.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""Kernel (f)'s stage: the refit of every candidate's mother rollouts and
their distance matrices (``qp.refit_coefficients``,
``kernels.distance_matrices``), the JAX package's
``mpc_mmd_tpu/solver.py:218``, ``reduced_set.py:425-450``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import distance_matrices
from .qp import Workspace, refit_coefficients


class InnerPrologue(NamedTuple):
    cx: torch.Tensor            # (B, M, nvar) refitted coefficients
    cy: torch.Tensor
    D: torch.Tensor             # (B, M, M) L1 distances of [cx | cy]
    D2: Optional[torch.Tensor]  # (B, M, M) squared L2 ones, or None (laplace)


def inner_prologue(ws: Workspace, xr: torch.Tensor, yr: torch.Tensor,
                   kind: str) -> InnerPrologue:
    """``qp.refit_coefficients`` of the N scenarios' mother rollouts xr, yr
    (N, C, M, T), then ``kernels.distance_matrices``."""
    N, C, M, T = xr.shape
    cx, cy = refit_coefficients(ws, xr.reshape(-1, T), yr.reshape(-1, T), N)
    cx, cy = cx.reshape(N * C, M, -1), cy.reshape(N * C, M, -1)
    return InnerPrologue(cx, cy, *distance_matrices(cx, cy, kind))