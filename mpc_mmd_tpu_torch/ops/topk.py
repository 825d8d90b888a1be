"""K1 and K5: row-wise top-k indices, and with K5 their one-hot rows
(CUDA source ``csrc/topk.cu``, one kernel body for both).

K1 replaces ``mpc_mmd_tpu/ops/topk_pallas.py::topk_indices_pallas``.  On the
solve paths it picks the top-k |beta| lanes of every inner-CEM sample
((C, S - n_el, M+1) with ``slice_to=M``, and the shared iteration-0 batch
(1, S, M+1)) and the elite samples (top-n_el of -cost over (C, S)): rows
from 64 to 8,900, with k = num_reduced = N of M = N^2 ranked lanes, N = 2
... 16 (101 floats with k = 10 on the fastrt and dynamic paths, 17 with
k = 4 on the on-road path, 26 and 226 at the record's N = 5 and 15), and
64 or 100 floats with k = 7 or 11 at the elite pick.  The kernel ranks at
most :data:`MAX_WIDTH` = 256 lanes (N = 16).  K5 replaces
``topk_onehot_pallas``, which no path of either package calls.

Both run k rounds per row, as the Pallas kernel does: the max, the lowest
column holding it, that column masked to -inf.  On the card a round is two
warp reductions on integer order keys, one row per warp while the card
holds every row's warp at once and two rows per warp past that (the
occupancy decides), and the k indices of a row are stored at once.  A row is a chain of k dependent rounds, so
the kernel is bound by that chain's latency and the launch, not by its
bytes; the note at the top of the CUDA source has the numbers and the
design.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

MAX_WIDTH = 256   # 8 columns a lane: M = N^2 up to N = 16


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


def _check(x: torch.Tensor, k: int, slice_to: Optional[int]) -> int:
    """The ranked width m; raises on arguments neither version takes."""
    width = x.shape[-1]
    m = width if slice_to is None else slice_to
    if not 0 < m <= width:
        raise ValueError(f"slice_to={slice_to} outside (0, {width}]")
    if k < 1:
        raise ValueError(f"k={k} must be positive")
    return m


def _require_kernel(name: str, x: torch.Tensor, m: int) -> None:
    _build.require_cuda_f32(name, x)
    if m > MAX_WIDTH:
        raise ValueError(f"{name}: ranks at most {MAX_WIDTH} lanes, got {m}")


def topk_indices(x: torch.Tensor, k: int, absolute: bool = False,
                 slice_to: Optional[int] = None) -> torch.Tensor:
    """Top-k indices (descending) along the last axis, int32 (..., k).

    Ranks the first ``slice_to`` lanes (default all) of |x| if
    ``absolute`` else x.  Ties go to the lowest index; NaN ranks last.
    A CPU tensor takes :func:`topk_indices_plain`; a CUDA tensor launches
    the kernel (float32, contiguous, at most 256 lanes ranked).
    """
    m = _check(x, k, slice_to)
    if x.device.type == "cpu":
        return topk_indices_plain(x, k, absolute, slice_to)
    _require_kernel("topk_indices", x, m)
    width = x.shape[-1]
    out = torch.empty(x.shape[:-1] + (k,), dtype=torch.int32, device=x.device)
    err = _build.library().mmd_topk_indices(
        x.data_ptr(), out.data_ptr(), x.numel() // width, width, m, k,
        int(absolute), _build.stream())
    _build.check(err, "topk_indices")
    topk_indices.launches += 1
    return out


topk_indices.launches = 0


def topk_onehot_plain(x: torch.Tensor, k: int, absolute: bool = False,
                      slice_to: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K5: K1's indices and their float32 indicator rows."""
    m = x.shape[-1] if slice_to is None else slice_to
    idx = topk_indices_plain(x, k, absolute, slice_to)
    iota = torch.arange(m, device=x.device)
    return idx, (idx[..., None] == iota).to(torch.float32)


def topk_onehot(x: torch.Tensor, k: int, absolute: bool = False,
                slice_to: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k indices and their one-hot rows along the last axis.

    Returns (idx (..., k) int32, onehot (..., k, m) float32), with m the
    ranked width and ``onehot[..., j, :]`` the indicator of
    ``idx[..., j]``; ranking as :func:`topk_indices`.  A CPU tensor takes
    :func:`topk_onehot_plain`; a CUDA tensor launches the kernel.
    """
    m = _check(x, k, slice_to)
    if x.device.type == "cpu":
        return topk_onehot_plain(x, k, absolute, slice_to)
    _require_kernel("topk_onehot", x, m)
    width = x.shape[-1]
    idx = torch.empty(x.shape[:-1] + (k,), dtype=torch.int32, device=x.device)
    onehot = torch.empty(x.shape[:-1] + (k, m), dtype=torch.float32,
                         device=x.device)
    err = _build.library().mmd_topk_onehot(
        x.data_ptr(), idx.data_ptr(), onehot.data_ptr(), x.numel() // width,
        width, m, k, int(absolute), _build.stream())
    _build.check(err, "topk_onehot")
    topk_onehot.launches += 1
    return idx, onehot


topk_onehot.launches = 0
