"""K3: the fused selection stage of the inner beta-CEM (``csrc/topk_kernel.cu``).

Replaces ``mpc_mmd_tpu/ops/topk_kernel_pallas.py::topk_kernel_matrices``:
top-k of |beta|, the gather of the k selected rows of the candidate's
(M, M) L1 distance matrix, ``exp(-rows / sigma)``, its row sums and the
k x k reduced kernel matrix, in one launch.  The "fused" selection of
:func:`mpc_mmd_tpu_torch.reduced_set.select_reduced_set_batched` runs it on
every inner-CEM iteration, at M = N^2 lanes and k = N for N = 2 ... 16.
What bounds it on the card and what the design does about it, D staged in
shared memory up to M = 128 and read from device memory past it: see the
note at the top of the CUDA source.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

MAX_WIDTH = 256   # M, the lanes ranked and the side of D (N = 16)
MAX_K = 32

_MASK = 3.0e38


def topk_kernel_matrices_plain(samples: torch.Tensor, D: torch.Tensor, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin, the Pallas body's arithmetic step for step.

    k rounds of max, lowest index at or above the max, and a subtracted
    3.0e38 mask; no NaN mask, so a row with a NaN lane emits index M every
    round and gets zero rows (see the CUDA source).  The selected rows are
    gathered directly, which equals the Pallas one-hot product on finite D.
    """
    C, S, Mp1 = samples.shape
    M = Mp1 - 1
    sigma = samples[..., M]
    absb = torch.abs(samples[..., :M])
    iota = torch.arange(M, dtype=samples.dtype, device=samples.device)
    cols = []
    for _ in range(k):
        m = torch.amax(absb, dim=-1, keepdim=True)
        first = torch.amin(torch.where(absb >= m, iota, float(M)), dim=-1,
                           keepdim=True)
        onehot = (torch.abs(iota - first) < 0.5).to(samples.dtype)
        cols.append(first[..., 0])
        absb = absb - onehot * _MASK
    idx = torch.stack(cols, dim=-1).to(torch.int32)          # (C, S, k)
    # index M reads a zero row, and a zero column of E, like an all-zero
    # one-hot row of the Pallas product
    D_pad = torch.cat((D, D.new_zeros(C, 1, M)), dim=1)     # (C, M+1, M)
    c_ix = torch.arange(C, device=D.device)[:, None, None]
    rows = D_pad[c_ix, idx.long()]                           # (C, S, k, M)
    E = torch.exp(-rows / sigma[..., None, None])
    row_sum = torch.sum(E, dim=-1)
    E_pad = torch.cat((E, E.new_zeros(E.shape[:-1] + (1,))), dim=-1)
    K_red = torch.gather(E_pad, 3, idx.long()[:, :, None, :].expand(C, S, k, k))
    return row_sum, K_red, idx


def topk_kernel_matrices(samples: torch.Tensor, D: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """samples (C, S, M+1) of |beta| lanes and a bandwidth; D (C, M, M).

    Returns (row_sum (C, S, k), K_red (C, S, k, k), idx (C, S, k) int32).
    A CPU tensor takes :func:`topk_kernel_matrices_plain`; a CUDA tensor
    launches the kernel: float32, D contiguous, each candidate's (S, M+1)
    block contiguous with a candidate stride of S*(M+1) or 0 (one batch
    broadcast to every candidate), M <= 256, k <= 32.
    """
    if samples.dim() != 3 or D.dim() != 3:
        raise ValueError(f"topk_kernel_matrices: samples {tuple(samples.shape)} "
                         f"and D {tuple(D.shape)} must be 3-d")
    C, S, Mp1 = samples.shape
    M = Mp1 - 1
    if tuple(D.shape) != (C, M, M):
        raise ValueError(f"topk_kernel_matrices: D {tuple(D.shape)} does not "
                         f"match samples {tuple(samples.shape)}")
    if not 0 < k <= M:
        raise ValueError(f"k={k} outside (0, {M}]")
    if samples.device.type == "cpu" and D.device.type == "cpu":
        return topk_kernel_matrices_plain(samples, D, k)
    _build.require_cuda_f32("topk_kernel_matrices", D, samples[0])
    block = S * Mp1
    stride = samples.stride(0) if C > 1 else block
    if stride not in (0, block):
        raise ValueError(f"topk_kernel_matrices: candidate stride {stride}, "
                         f"expected {block} or 0")
    if M > MAX_WIDTH or k > MAX_K:
        raise ValueError(f"topk_kernel_matrices: the kernel takes M <= "
                         f"{MAX_WIDTH} and k <= {MAX_K}, got M={M}, k={k}")
    dev = samples.device
    row_sum = torch.empty(C, S, k, dtype=torch.float32, device=dev)
    K_red = torch.empty(C, S, k, k, dtype=torch.float32, device=dev)
    idx = torch.empty(C, S, k, dtype=torch.int32, device=dev)
    err = _build.library().mmd_topk_kernel_matrices(
        samples.data_ptr(), stride, D.data_ptr(), row_sum.data_ptr(),
        K_red.data_ptr(), idx.data_ptr(), C, S, M, k, _build.stream())
    _build.check(err, "topk_kernel_matrices")
    topk_kernel_matrices.launches += 1
    return row_sum, K_red, idx


topk_kernel_matrices.launches = 0
