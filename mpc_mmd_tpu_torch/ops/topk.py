"""K1: row-wise top-k indices (CUDA source ``csrc/topk.cu``).

Replaces ``mpc_mmd_tpu/ops/topk_pallas.py::topk_indices_pallas``.  On the
main path it picks the top-10 |beta| lanes of every inner-CEM sample
((C, S', M+1) with ``slice_to=M``) and the elite samples (top-7 of -cost
over (C, S)).  What bounds it on the card and what the design does about
it: see the note at the top of the CUDA source.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

MAX_WIDTH = 128


def topk_indices_plain(x: torch.Tensor, k: int, absolute: bool = False,
                       slice_to: Optional[int] = None) -> torch.Tensor:
    """Plain twin: k rounds of argmax and mask, NaN mapped to -inf.

    Ties go to the lowest index (``torch.argmax`` returns the first
    maximum); int32 (..., k) like the kernel.
    """
    y = x if slice_to is None else x[..., :slice_to]
    if absolute:
        y = torch.abs(y)
    y = torch.where(torch.isnan(y), torch.full_like(y, -torch.inf), y)
    idxs = []
    for _ in range(k):
        i = torch.argmax(y, dim=-1, keepdim=True)
        idxs.append(i)
        y = y.scatter(-1, i, -torch.inf)
    return torch.cat(idxs, dim=-1).to(torch.int32)


def topk_indices(x: torch.Tensor, k: int, absolute: bool = False,
                 slice_to: Optional[int] = None) -> torch.Tensor:
    """Top-k indices (descending) along the last axis, int32 (..., k).

    Ranks the first ``slice_to`` lanes (default all) of |x| if
    ``absolute`` else x.  Ties go to the lowest index; NaN ranks last.
    A CPU tensor takes :func:`topk_indices_plain`; a CUDA tensor launches
    the kernel (float32, contiguous, last axis at most 128 wide).
    """
    width = x.shape[-1]
    m = width if slice_to is None else slice_to
    if not 0 < m <= width:
        raise ValueError(f"slice_to={slice_to} outside (0, {width}]")
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    if x.device.type == "cpu":
        return topk_indices_plain(x, k, absolute, slice_to)
    _build.require_cuda_f32("topk_indices", x)
    if m > MAX_WIDTH:
        raise ValueError(f"topk_indices: ranks at most {MAX_WIDTH} lanes, got {m}")
    rows = x.numel() // width
    out = torch.empty(x.shape[:-1] + (k,), dtype=torch.int32, device=x.device)
    err = _build.library().mmd_topk_indices(
        x.data_ptr(), out.data_ptr(), rows, width, m, k, int(absolute),
        _build.stream())
    _build.check(err, "topk_indices")
    topk_indices.launches += 1
    return out


topk_indices.launches = 0
