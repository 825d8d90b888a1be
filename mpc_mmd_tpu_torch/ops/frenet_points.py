"""Kernel (g): the Frenet coordinates of the on-road solve's rollout points
in one launch (CUDA source ``csrc/frenet_points.cu``); its plain version
is ``frenet.global_to_frenet_points``.

The JAX package converts the rollouts inside its jitted outer ``lax.scan``
(``mpc_mmd_tpu/frenet.py:229``, called at ``solver_frenet.py:197``), which
XLA fuses.  The port's chain of PyTorch operations for it builds two
(points, path) distance buffers for the nearest-point argmin, then the
gathers and ``interp``'s arithmetic twice (about 78 launches an outer
iteration at Path D); :func:`frenet_points` runs it in one launch, a
thread a point, with s and l carrying the chain's bits.  Every Frenet mode
that rolls out (``mmd_opt``, ``cvar``, ``saa``, ``mmd_random``) calls it
on the card under the "prefactored" strategy
(``solver.SolverSetup._routes``); the ego's and the obstacles' conversions
(``global_to_frenet_state``, ``global_to_frenet_obstacle``: a handful of
points a solve) keep the chain.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from ..frenet import FrenetFrame, global_to_frenet_points

MAX_PATH = 227 * 1024 // 20   # path points: five float arrays in shared memory
# frenet.interp's bound on an interval's width
TINY = float(np.spacing(np.finfo(np.float32).eps))


def frenet_points(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor, *, lib=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, l) of the points x, y (any one shape) against ``frame``'s path:
    the arc length of the nearest path point and the signed lateral offset
    along the unit normal there.

    CPU tensors take ``frenet.global_to_frenet_points``; CUDA tensors
    launch kernel (g) (float32, one device, a path of 2 to
    :data:`MAX_PATH` points) or raise.  ``lib``: another build of the
    kernels' library (``utils/kernel_ab.py``), else the package's.
    """
    if y.shape != x.shape:
        raise ValueError(f"frenet_points: x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"must be the same shape")
    path = (frame.x_path, frame.y_path, frame.Fx_dot, frame.Fy_dot, frame.arc_vec)
    n = frame.x_path.shape[0]
    if any(t.shape != (n,) for t in path):
        raise ValueError("frenet_points: the path's x, y, Fx_dot, Fy_dot and arc_vec "
                         "must be 1-d of one length")
    if all(t.device.type == "cpu" for t in (x, y) + path):
        return global_to_frenet_points(frame, x, y)
    x, y = x.contiguous(), y.contiguous()
    path = tuple(t.contiguous() for t in path)
    _build.require_cuda_f32("frenet_points", x, y, *path)
    if not 2 <= n <= MAX_PATH:
        raise ValueError(f"frenet_points: the kernel takes a path of 2 to {MAX_PATH} "
                         f"points, got {n}")
    s, l = torch.empty_like(x), torch.empty_like(x)
    lib = lib or _build.library()
    err = lib.mmd_frenet_points(x.data_ptr(), y.data_ptr(),
                                *(t.data_ptr() for t in path), s.data_ptr(),
                                l.data_ptr(), x.numel(), n, TINY, _build.stream())
    _build.check(err, "frenet_points")
    frenet_points.launches += 1
    return s, l


frenet_points.launches = 0
