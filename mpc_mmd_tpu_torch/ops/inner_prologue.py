"""Kernel (f): the inner CEM's prologue, the refit of every candidate's
mother rollouts and their distance matrices, in one launch (CUDA source
``csrc/inner_prologue.cu``), and its plain version.

The JAX package refits the mother rollouts and takes their distance
matrices inside its jitted outer ``lax.scan`` (``mpc_mmd_tpu/solver.py:218``,
``reduced_set.py:425-450``), which XLA fuses.  :func:`inner_prologue_plain`
is the port's chain of PyTorch operations for it (``qp.refit_coefficients``:
two ``linalg.scenario_mm`` products a channel; ``kernels.distance_matrices``:
``pairwise_l1`` and, for the gaussian and matern52 kernels,
``pairwise_l2sq``); :func:`inner_prologue` runs all of it in one launch, a
candidate a thread-block cluster of 1, 2 or 4 CTAs (:func:`launch_shape`),
with every output carrying the plain chain's bits.  Every
prefactored selection of the inner CEM reads its D (and D2) on the card
(``reduced_set.select_reduced_set_batched``'s ``distances``); the "exact"
strategy and the candidate split keep the chain
(``solver.SolverSetup._routes``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from ..kernels import distance_matrices
from ..qp import Workspace, refit_coefficients

MAX_NVAR = 16                 # F = 2 nvar features a rollout
MAX_SMEM = 227 * 1024         # the shared memory a CTA may take


class InnerPrologue(NamedTuple):
    cx: torch.Tensor            # (B, M, nvar) refitted coefficients
    cy: torch.Tensor
    D: torch.Tensor             # (B, M, M) L1 distances of [cx | cy]
    D2: Optional[torch.Tensor]  # (B, M, M) squared L2 ones, or None (laplace)


def inner_prologue_plain(ws: Workspace, xr: torch.Tensor, yr: torch.Tensor,
                         kind: str) -> InnerPrologue:
    """Plain version of :func:`inner_prologue`: ``qp.refit_coefficients``
    of the N scenarios' rows, then ``kernels.distance_matrices``."""
    N, C, M, T = xr.shape
    cx, cy = refit_coefficients(ws, xr.reshape(-1, T), yr.reshape(-1, T), N)
    cx, cy = cx.reshape(N * C, M, -1), cy.reshape(N * C, M, -1)
    return InnerPrologue(cx, cy, *distance_matrices(cx, cy, kind))


CLUSTERS = (1, 2, 4)          # CTAs a candidate may take


def smem_bytes(M: int, T: int, nvar: int, cluster: int) -> int:
    """Shared memory of a CTA (csrc/inner_prologue.cu's layout): an
    mbarrier, its M / cluster rows of x and y (or, once spent, its warps'
    row buffers of D: 8 x 32 x 9 floats), the features (M, 2 nvar rounded
    up to 4), P and Rinv with rows of nvar rounded up to 4, and aa."""
    r4 = lambda n: (n + 3) & ~3
    rows = -(-M // cluster)
    staged = max(2 * r4(rows * T + 4), 8 * 32 * 9)
    floats = 4 + staged + M * r4(2 * nvar) + (T + nvar) * r4(nvar) + r4(M)
    return 4 * floats


def launch_shape(B: int, M: int, T: int, nvar: int, sms: int) -> int:
    """CTAs a candidate takes (a thread-block cluster): two where two
    CTAs a candidate still fit the card's ``sms`` multiprocessors one a
    multiprocessor (fastrt's 64 candidates on 132), else one; more where a
    CTA's shared memory passes :data:`MAX_SMEM`.  (At one CTA each Path
    A's 100 candidates ran faster than at two, F15's within 3 %: PERF.md.)
    Raises ValueError where none fits."""
    fits = [c for c in CLUSTERS if smem_bytes(M, T, nvar, c) <= MAX_SMEM]
    if nvar > MAX_NVAR or not fits:
        raise ValueError(f"inner_prologue: the kernel takes nvar <= {MAX_NVAR} and a "
                         f"candidate's {M} x {T} rollouts within {len(CLUSTERS)} CTAs of "
                         f"{MAX_SMEM} bytes of shared memory, got nvar {nvar}")
    want = 2 if 2 * B <= sms else 1
    return next((c for c in fits if c >= want), fits[-1])


def inner_prologue(ws: Workspace, xr: torch.Tensor, yr: torch.Tensor, kind: str,
                   *, lib=None, cluster: Optional[int] = None) -> InnerPrologue:
    """The refitted coefficients and distance matrices of the mother
    rollouts xr, yr (N, C, M, T) of N scenarios' C candidates: cx, cy (N C,
    M, nvar), D (N C, M, M) and, for ``kind`` gaussian and matern52, D2.

    CPU tensors take :func:`inner_prologue_plain`; CUDA tensors launch
    kernel (f) (float32, one device, nvar <= 16, a candidate's share of its
    rollouts within a CTA's shared memory) or raise.  ``lib``: another
    build of the kernels' library (``utils/kernel_ab.py``), else the
    package's; ``cluster``: CTAs a candidate, else :func:`launch_shape`'s.
    """
    if xr.dim() != 4 or yr.shape != xr.shape:
        raise ValueError(f"inner_prologue: xr {tuple(xr.shape)} and yr "
                         f"{tuple(yr.shape)} must be the same (N, C, M, T)")
    N, C, M, T = xr.shape
    nvar = ws.P_prime.shape[1]
    if ws.P_prime.shape[0] != T:
        raise ValueError(f"inner_prologue: P_prime {tuple(ws.P_prime.shape)} does "
                         f"not take {T} steps")
    if xr.device.type == "cpu" and yr.device.type == "cpu":
        return inner_prologue_plain(ws, xr, yr, kind)
    xr, yr = xr.contiguous(), yr.contiguous()
    _build.require_cuda_f32("inner_prologue", xr, yr, ws.P_prime, ws.refit_inv)
    B = N * C
    shape = launch_shape(B, M, T, nvar, torch.cuda.get_device_properties(xr.device)
                         .multi_processor_count)
    if cluster is not None:
        if cluster not in CLUSTERS or smem_bytes(M, T, nvar, cluster) > MAX_SMEM:
            raise ValueError(f"inner_prologue: cluster {cluster} is not one of "
                             f"{CLUSTERS} that fits")
        shape = cluster
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=xr.device)
    out = InnerPrologue(new(B, M, nvar), new(B, M, nvar), new(B, M, M),
                        None if kind == "laplace" else new(B, M, M))
    lib = lib or _build.library()
    err = lib.mmd_inner_prologue(
        xr.data_ptr(), yr.data_ptr(), ws.P_prime.data_ptr(), ws.refit_inv.data_ptr(),
        out.cx.data_ptr(), out.cy.data_ptr(), out.D.data_ptr(),
        None if out.D2 is None else out.D2.data_ptr(), B, M, T, nvar, shape,
        _build.stream())
    _build.check(err, "inner_prologue")
    inner_prologue.launches += 1
    return out


inner_prologue.launches = 0
