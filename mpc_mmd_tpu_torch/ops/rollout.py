"""K4: fused bicycle-kinematics rollout (CUDA source ``csrc/rollout.cu``),
and K4n, its noisy-controls entry.

K4 replaces ``mpc_mmd_tpu/ops/rollout_pallas.py::fused_rollout``.  In the
JAX package that kernel is opt-in; here it rolls out the Monte-Carlo
validator's lanes and the "exact" strategy's and the candidate split's.
K4n (:func:`noisy_rollout`) is the rollout of the main path: 6400 lanes
(64 candidates x 100 mother rollouts) x 50 steps per outer iteration,
each lane's noisy controls formed from its candidate's controls and the
iteration's draws in shared memory, where K4 copies its controls in, so
that the chain of ``solver.noisy_controls`` and the pairing of
``paired_rollouts`` (its plain version, :func:`noisy_rollout_plain`)
never writes them to device memory.  What bounds both on the card and
what the design does about it: see the notes at the top of the CUDA
source.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import _build
from ..config import NoiseConfig
from ..dynamics import perturb_controls
from ..dynamics import rollout as rollout_plain

MAX_STEPS = 900   # T: a block's two (32, T) slabs fit in shared memory (K4)
MAX_SMEM = 227 * 1024         # the shared memory a block may take
SMALL_LAUNCH = 12800          # K4n: lanes a launch up to which a block takes 32


def noisy_lanes(lanes: int) -> int:
    """K4n's lanes a block (csrc/rollout.cu's noisy_lanes): 32 up to
    :data:`SMALL_LAUNCH` lanes a launch, 64 up to twice that, else 160."""
    return 32 if lanes <= SMALL_LAUNCH else 64 if lanes <= 2 * SMALL_LAUNCH else 160


def noisy_smem_bytes(N: int, C: int, R: int, per: int, dc: int, T: int) -> int:
    """Shared memory of a K4n block (csrc/rollout.cu's noisy_layout) for N
    x C candidates of ``per`` lanes: the two (LB, T | 1) slabs at
    :func:`noisy_lanes`' LB lanes a block, the acc and steer rows of the
    most candidates a block's lanes touch, and the draw and eps_const slabs
    of the most scenarios (or, under Beta noise, candidates) they touch,
    each with room for its source's place in a 16-byte block.  A block
    starts at a multiple of LB lanes, at most span - gcd(LB, span) lanes
    into a candidate or scenario of span lanes."""
    LB = noisy_lanes(N * C * per)
    spanned = lambda span: 1 + (span - math.gcd(LB, span) + LB - 1) // span
    nc, ns = spanned(per), spanned(C * per)
    nd = nc if dc > 1 else ns
    ctl = (nc * T + 4 + 3) & ~3
    draw, eps = (nd * R * T + 8) & ~3, (ns * R * T + 8) & ~3
    return 4 * (2 * LB * (T | 1) + 4 + 2 * ctl + 2 * draw + eps)


def fused_rollout(acc: torch.Tensor, steer: torch.Tensor, state0: torch.Tensor,
                  dt: float, wheel_base: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, y position stacks (L, T) of lanes driven by acc, steer (L, T).

    state0 is (5,) shared by every lane or (L, 5).  Column t holds the state
    before controls[t].  A CPU tensor takes the plain loop
    (``dynamics.rollout``); a CUDA tensor launches the kernel (float32,
    contiguous, T at most :data:`MAX_STEPS`).
    """
    if acc.dim() != 2 or steer.shape != acc.shape:
        raise ValueError(f"fused_rollout: acc {tuple(acc.shape)} and steer "
                         f"{tuple(steer.shape)} must be the same (L, T)")
    L, T = acc.shape
    if state0.shape not in ((5,), (L, 5)):
        raise ValueError(f"fused_rollout: state0 {tuple(state0.shape)} is "
                         f"neither (5,) nor ({L}, 5)")
    if acc.device.type == "cpu":
        return rollout_plain(acc, steer, state0, dt, wheel_base)
    _build.require_cuda_f32("fused_rollout", acc, steer, state0)
    if T > MAX_STEPS:
        raise ValueError(f"fused_rollout: the kernel takes T <= {MAX_STEPS}, "
                         f"got {T}")
    x = torch.empty_like(acc)
    y = torch.empty_like(acc)
    err = _build.library().mmd_fused_rollout(
        acc.data_ptr(), steer.data_ptr(), state0.data_ptr(),
        0 if state0.dim() == 1 else 5, x.data_ptr(), y.data_ptr(), L, T,
        float(dt), float(wheel_base), _build.stream())
    _build.check(err, "fused_rollout")
    fused_rollout.launches += 1
    return x, y


fused_rollout.launches = 0


def paired_rollouts(a_n: torch.Tensor, s_n: torch.Tensor, state0: torch.Tensor,
                    dt: float, wheel_base: float, mother: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollouts of every candidate's noisy controls as one flat-lane K4 call.

    a_n, s_n: the (..., C, R, T) noisy controls.  With ``mother``, row m
    pairs acc draw m // R with steer draw m % R, giving n = R^2 rollouts
    per candidate; else n = R.  state0 is (5,), shared by every rollout,
    or (n, 5): rollout m of every candidate starts from state m (the
    Frenet solve's noisy initial states), and K4 takes a state per lane.
    Returns x, y of shape (..., C, n, T).
    """
    R, T = a_n.shape[-2:]
    if mother:
        a_n = torch.repeat_interleave(a_n, R, dim=-2)
        s_n = s_n.repeat(*(1,) * (s_n.dim() - 2), R, 1)
    lead, n = a_n.shape[:-2], a_n.shape[-2]
    if state0.dim() == 2:
        state0 = state0.expand(*lead, n, 5).reshape(-1, 5)
    x, y = fused_rollout(a_n.reshape(-1, T), s_n.reshape(-1, T), state0, dt, wheel_base)
    return x.reshape(*lead, n, T), y.reshape(*lead, n, T)


def noisy_rollout_plain(acc: torch.Tensor, steer: torch.Tensor, d_acc: torch.Tensor,
                        d_steer: torch.Tensor, eps_const: torch.Tensor,
                        state0: torch.Tensor, noise: NoiseConfig, dt: float,
                        wheel_base: float, mother: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`noisy_rollout`: ``dynamics.perturb_controls``,
    then :func:`paired_rollouts` (K4 on CUDA tensors, its plain loop on
    the CPU)."""
    a_n, s_n = perturb_controls(acc, steer, d_acc, d_steer, eps_const, noise)
    return paired_rollouts(a_n, s_n, state0, dt, wheel_base, mother)


def noisy_rollout(acc: torch.Tensor, steer: torch.Tensor, d_acc: torch.Tensor,
                  d_steer: torch.Tensor, eps_const: torch.Tensor, state0: torch.Tensor,
                  noise: NoiseConfig, dt: float, wheel_base: float, mother: bool,
                  *, lib=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rollouts (N, C, n, T) of the noisy variants of N x C candidates'
    controls (K4n).

    acc, steer (N, C, T) the candidates' controls; d_acc, d_steer the
    iteration's draws, (N, 1, R, T) standard normals shared by a scenario's
    candidates (gaussian noise) or (N, C, R, T) Beta draws; eps_const (N,
    1, R, T); state0 (5,) or a state per rollout of a candidate (n, 5).
    ``mother``: n = R^2 rollouts a candidate, rollout m from acc draw m //
    R and steer draw m % R; else n = R.  The noisy controls are
    ``dynamics.perturb_controls``' (``noise``).

    CPU tensors take :func:`noisy_rollout_plain`; CUDA tensors launch K4n
    (float32, one device, a block's staging within :data:`MAX_SMEM` bytes
    of shared memory, :func:`noisy_smem_bytes`) or raise.  ``lib``:
    another build of the kernels' library (``utils/kernel_ab.py``), else
    the package's.
    """
    if acc.dim() != 3 or steer.shape != acc.shape:
        raise ValueError(f"noisy_rollout: acc {tuple(acc.shape)} and steer "
                         f"{tuple(steer.shape)} must be the same (N, C, T)")
    N, C, T = acc.shape
    R = eps_const.shape[-2]
    dc = d_acc.shape[1]
    if (eps_const.shape != (N, 1, R, T) or d_acc.shape != d_steer.shape
            or d_acc.shape not in ((N, 1, R, T), (N, C, R, T))):
        raise ValueError(f"noisy_rollout: draws {tuple(d_acc.shape)}, "
                         f"{tuple(d_steer.shape)} and eps_const "
                         f"{tuple(eps_const.shape)} do not fit controls {(N, C, T)}")
    per = R * R if mother else R
    if state0.shape not in ((5,), (per, 5)):
        raise ValueError(f"noisy_rollout: state0 {tuple(state0.shape)} is neither "
                         f"(5,) nor ({per}, 5)")
    if noise.kind == "gaussian" and dc != 1:
        raise ValueError("noisy_rollout: gaussian draws are shared by a scenario's "
                         "candidates, (N, 1, R, T)")
    inputs = (acc, steer, d_acc, d_steer, eps_const, state0)
    if all(t.device.type == "cpu" for t in inputs):
        return noisy_rollout_plain(*inputs, noise, dt, wheel_base, mother)
    inputs = tuple(t.contiguous() for t in inputs)
    _build.require_cuda_f32("noisy_rollout", *inputs)
    smem = noisy_smem_bytes(N, C, R, per, dc, T)
    if smem > MAX_SMEM:
        raise ValueError(f"noisy_rollout: a block would stage {smem} bytes at {R} draws "
                         f"x {T} steps, past the {MAX_SMEM} bytes of shared memory")
    x = torch.empty(N, C, per, T, dtype=torch.float32, device=acc.device)
    y = torch.empty_like(x)
    f32 = lambda v: float(np.float32(v))
    lib = lib or _build.library()
    err = lib.mmd_noisy_rollout(
        *(t.data_ptr() for t in inputs), 0 if state0.dim() == 1 else 5,
        x.data_ptr(), y.data_ptr(), N, C, R, per, dc, int(mother),
        0 if noise.kind == "gaussian" else 1, f32(noise.level),
        f32(noise.k_steer * noise.level), f32(noise.acc_const), f32(noise.steer_const),
        T, float(dt), float(wheel_base), _build.stream())
    _build.check(err, "noisy_rollout")
    noisy_rollout.launches += 1
    return x, y


noisy_rollout.launches = 0
