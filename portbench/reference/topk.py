# Frozen copy of the plain chain of mpc_mmd_tpu_torch/ops/topk.py (commit
# eb91b04), the stage as PyTorch operations on any device.  The
# benchmark's yardstick: do not edit it to follow the port.
"""K1's stage: row-wise top-k indices, k rounds a row of the max, the
lowest column holding it, that column masked to -inf.
"""

from __future__ import annotations

from typing import Optional

import torch


def topk_indices(x: torch.Tensor, k: int, absolute: bool = False,
                 slice_to: Optional[int] = None) -> torch.Tensor:
    """k rounds of argmax and mask, NaN mapped to -inf.

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
