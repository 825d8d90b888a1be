"""Kernel (g): the on-road solve's Frenet conversions on one nearest-point
search, an exact tile-pruned scan of the path (CUDA source
``csrc/frenet_points.cu``), in three forms:

* :func:`frenet_points`, the rollouts' (s, l), one launch an outer
  iteration; plain version ``frenet.global_to_frenet_points``;
* :func:`frenet_states`, the noisy initial states after their draw (the
  states, their Frenet states, the six means and the boundary rows), one
  launch a solve; plain version ``frenet.initial_states``;
* :func:`frenet_obstacles`, the obstacles' (s, l, vs, vl, psi_rel) and
  their constant-velocity trajectories, one launch a closed-loop step;
  plain version ``frenet.global_to_frenet_obstacle`` and
  ``dynamics.constant_velocity_obstacles``.

The JAX package converts inside its jitted solve (``mpc_mmd_tpu/frenet.py``
``_nearest`` :168, called at ``solver_frenet.py:133-138`` and :197) and
closed loop (``closedloop.py:268``), which XLA fuses; the port's chains of
PyTorch operations build (points, path) distance buffers for the argmin,
then the gathers and ``interp``'s arithmetic.  Each form's outputs carry
its chain's bits.  A warp takes 32 consecutive points (a lane a point) and
visits only the tiles of 32 path points whose bounding box could hold a
point as near as its best so far; :func:`nearest_pruned` is the search's
twin (tests and ``chip_smoke.py``).  The solver's routes
(``solver.SolverSetup._glue_routes``) send every Frenet mode that rolls
out to :func:`frenet_points` and every on-road solve to
:func:`frenet_states` under the "prefactored" strategy;
``closedloop.local_problem`` converts its obstacles through
:func:`frenet_obstacles`.  Each wrapper runs its plain version for CPU
tensors and launches its kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build
from ..dynamics import constant_velocity_obstacles
from ..frenet import (FrenetFrame, _nearest, global_to_frenet_obstacle,
                      global_to_frenet_points, initial_states)

TILE = 32          # path points a tile (csrc/frenet_points.cu kTile)
MAX_PATH = 6800    # path points: the staged path within a CTA's shared memory
MAX_STATES = 256   # the state form's states: a lane each in one CTA
# frenet.interp's bound on an interval's width
TINY = float(np.spacing(np.finfo(np.float32).eps))


def _path(frame: FrenetFrame, name: str, kappa: bool = False):
    path = (frame.x_path, frame.y_path, frame.Fx_dot, frame.Fy_dot, frame.arc_vec)
    path += (frame.kappa,) if kappa else ()
    n = frame.x_path.shape[0]
    if any(t.shape != (n,) for t in path):
        raise ValueError(f"{name}: the path's x, y, Fx_dot, Fy_dot, arc_vec (and kappa) "
                         f"must be 1-d of one length")
    return path, n


def _card(name: str, path, n: int, *tensors):
    """The CUDA operands, contiguous and checked."""
    path = tuple(t.contiguous() for t in path)
    tensors = tuple(t.contiguous() for t in tensors)
    _build.require_cuda_f32(name, *tensors, *path)
    if not 2 <= n <= MAX_PATH:
        raise ValueError(f"{name}: the kernel takes a path of 2 to {MAX_PATH} points, "
                         f"got {n}")
    return path, tensors


def _check_points(x, y):
    if y.shape != x.shape:
        raise ValueError(f"frenet_points: x {tuple(x.shape)} and y {tuple(y.shape)} "
                         f"must be the same shape")


def _probe_out(probe: bool, shape, dev):
    """The probe's outputs, each point's nearest index and the tiles its
    warp visited (int32 of ``shape``), and their pointers; else Nones."""
    if not probe:
        return (), (None, None)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    visits = torch.empty_like(idx)
    return (idx, visits), (idx.data_ptr(), visits.data_ptr())


def _twin_probe(probe: bool, frame: FrenetFrame, x, y):
    """On the CPU, the probe's outputs from the twin (:func:`nearest_pruned`)."""
    return tuple(t.int() for t in nearest_pruned(frame, x, y)) if probe else ()


def frenet_points(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor, *, lib=None,
                  probe: bool = False) -> Tuple[torch.Tensor, ...]:
    """(s, l) of the points x, y (any one shape) against ``frame``'s path:
    the arc length of the nearest path point and the signed lateral offset
    along the unit normal there.

    CPU tensors take ``frenet.global_to_frenet_points``; CUDA tensors
    launch kernel (g) (float32, one device, a path of 2 to
    :data:`MAX_PATH` points) or raise.  ``lib``: another build of the
    kernels' library (``utils/kernel_ab.py``), else the package's.
    ``probe`` (a check's launch, not counted): also each point's nearest
    index and its warp's visited tiles, int32 of x's shape (on the CPU the
    twin's).
    """
    _check_points(x, y)
    path, n = _path(frame, "frenet_points")
    if all(t.device.type == "cpu" for t in (x, y) + path):
        return global_to_frenet_points(frame, x, y) + _twin_probe(probe, frame, x, y)
    path, (x, y) = _card("frenet_points", path, n, x, y)
    out = torch.empty((2,) + x.shape, device=x.device)
    extra, ptrs = _probe_out(probe, x.shape, x.device)
    lib = lib or _build.library()
    _build.check(lib.mmd_frenet_points(x.data_ptr(), y.data_ptr(),
                                       *(t.data_ptr() for t in path), out[0].data_ptr(),
                                       out[1].data_ptr(), *ptrs, x.numel(), n, TINY,
                                       _build.stream()), "frenet_points")
    if not probe:
        frenet_points.launches += 1
    return (out[0], out[1]) + extra


frenet_points.launches = 0


def frenet_states(frame: FrenetFrame, z: torch.Tensor, init_state: torch.Tensor,
                  mu: Sequence[float], sig: Sequence[float], nb: int, *, lib=None,
                  probe: bool = False):
    """The on-road solve's noisy initial states after their draw, in one
    launch: (states0 (n, 5), b_eq_x (nb, 3), b_eq_y (nb, 4)) of the draws
    ``z`` (n, 4) and the global state ``init_state`` (6,), as
    ``frenet.initial_states`` computes them.

    CPU tensors take ``frenet.initial_states``; CUDA tensors launch kernel
    (g)'s state form (float32, 1 to :data:`MAX_STATES` states) or raise.
    ``probe`` (a check's launch, not counted): also each state's nearest
    index and its warp's visited tiles (on the CPU the twin's).
    """
    n = z.shape[0]
    if z.dim() != 2 or z.shape[1] != 4 or init_state.shape != (6,):
        raise ValueError(f"frenet_states: z must be (n, 4) and init_state (6,), got "
                         f"{tuple(z.shape)} and {tuple(init_state.shape)}")
    path, m = _path(frame, "frenet_states", kappa=True)
    if all(t.device.type == "cpu" for t in (z, init_state) + path):
        out = initial_states(frame, z, init_state, mu, sig, nb)
        return out + _twin_probe(probe, frame, out[0][:, 0], out[0][:, 1])
    if not 1 <= n <= MAX_STATES:
        raise ValueError(f"frenet_states: the kernel takes 1 to {MAX_STATES} states, "
                         f"got {n}")
    path, (z, init_state) = _card("frenet_states", path, m, z, init_state)
    dev = z.device
    states = torch.empty((n, 5), device=dev)
    b_eq_x, b_eq_y = torch.empty((nb, 3), device=dev), torch.empty((nb, 4), device=dev)
    extra, ptrs = _probe_out(probe, (n,), dev)
    lib = lib or _build.library()
    _build.check(lib.mmd_frenet_states(
        z.data_ptr(), init_state.data_ptr(), *(t.data_ptr() for t in path),
        states.data_ptr(), b_eq_x.data_ptr(), b_eq_y.data_ptr(), *ptrs, n, nb, m,
        float(mu[0]), float(mu[1]), float(sig[0]), float(sig[1]), 1.0 / n, TINY,
        _build.stream()), "frenet_states")
    if not probe:
        frenet_states.launches += 1
    return (states, b_eq_x, b_eq_y) + extra


frenet_states.launches = 0


def frenet_obstacles(frame: FrenetFrame, obs: torch.Tensor, *, tot_time: torch.Tensor = None,
                     lib=None, probe: bool = False):
    """The obstacles' rows ``obs`` (m, 5) [x, y, vx, vy, psi] in Frenet:
    (s, l, vs, vl, psi_rel), each (m,), as
    ``frenet.global_to_frenet_obstacle`` converts them; with ``tot_time``
    (num,) also their constant-velocity trajectories x_obs, y_obs (m, num),
    as ``dynamics.constant_velocity_obstacles`` makes them.

    CPU tensors take ``frenet.global_to_frenet_obstacle`` (and
    ``constant_velocity_obstacles``); CUDA tensors launch kernel (g)'s
    obstacle form or raise.  ``probe`` (a check's launch, not counted):
    also each obstacle's nearest index and its warp's visited tiles (on the
    CPU the twin's).
    """
    if obs.dim() != 2 or obs.shape[1] != 5:
        raise ValueError(f"frenet_obstacles: obs must be (m, 5), got {tuple(obs.shape)}")
    if tot_time is not None and tot_time.dim() != 1:
        raise ValueError(f"frenet_obstacles: tot_time must be 1-d, got {tuple(tot_time.shape)}")
    path, n = _path(frame, "frenet_obstacles", kappa=True)
    times = () if tot_time is None else (tot_time,)
    if all(t.device.type == "cpu" for t in (obs,) + times + path):
        out = tuple(global_to_frenet_obstacle(frame, *obs.unbind(1)))
        if tot_time is not None:
            out += constant_velocity_obstacles(*out, tot_time)[:2]
        return out + _twin_probe(probe, frame, obs[:, 0], obs[:, 1])
    path, (obs, *times) = _card("frenet_obstacles", path, n, obs, *times)
    m, num = obs.shape[0], tot_time.shape[0] if times else 0
    out = torch.empty((5, m), device=obs.device)
    traj = torch.empty((2, m, num), device=obs.device) if times else None
    extra, ptrs = _probe_out(probe, (m,), obs.device)
    lib = lib or _build.library()
    _build.check(lib.mmd_frenet_obstacles(
        obs.data_ptr(), *(t.data_ptr() for t in path), out.data_ptr(), *ptrs,
        times[0].data_ptr() if times else None, traj.data_ptr() if times else None, num, m,
        n, TINY, _build.stream()), "frenet_obstacles")
    if not probe:
        frenet_obstacles.launches += 1
    return tuple(out.unbind(0)) + (tuple(traj.unbind(0)) if times else ()) + extra


frenet_obstacles.launches = 0


@functools.lru_cache(maxsize=None)
def _orders(tiles: int) -> torch.Tensor:
    """(tiles, tiles): row f the kernel's order of visits from tile f:
    f, f + 1, f - 1, f + 2, ... on alternate sides, then the side left."""
    rows = []
    for f in range(tiles):
        lo, hi, row = f - 1, f + 1, [f]
        for k in range(1, tiles):
            if hi < tiles and (lo < 0 or k & 1):
                row.append(hi)
                hi += 1
            else:
                row.append(lo)
                lo -= 1
        rows.append(row)
    return torch.tensor(rows, dtype=torch.long)


def nearest_pruned(frame: FrenetFrame, x: torch.Tensor, y: torch.Tensor,
                   tile: int = TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of kernel (g)'s search, in its algorithm: (idx, visits),
    each of x's shape, idx the nearest path point's index under
    torch.argmin's rule (``frenet._nearest``'s) and visits the tiles the
    point's warp visited.

    Warps of 32 consecutive points.  With a non-finite path coordinate, or
    a non-finite point in the warp, the warp's points take the full scan
    (``_nearest``) and count every tile.  Otherwise the path is cut into
    tiles of ``tile`` points with their bounding boxes; the warp starts at
    the tile whose box is nearest the box of its points (the first on a
    tie) and walks outwards on alternate sides; it visits a tile where some
    point's bound (the rounded squared distance to the box) is not greater
    than that point's best so far, and there every point takes the least
    (distance, index).  Every operation rounds on its own, as the kernel's.
    """
    xp, yp = frame.x_path, frame.y_path
    n, dev = xp.shape[0], xp.device
    xf, yf = x.reshape(-1), y.reshape(-1)
    P = xf.numel()
    T, W = -(-n // tile), -(-P // 32)
    inf = float("inf")

    def padded(t, fill, size):
        return torch.cat((t, t.new_full((size - t.shape[0],), fill)))

    live = padded(torch.ones(P, dtype=torch.bool, device=dev), False, 32 * W).view(W, 32)
    xq, yq = (padded(t, 0.0, 32 * W).view(W, 32) for t in (xf, yf))
    idx = torch.zeros((W, 32), dtype=torch.long, device=dev)
    visits = torch.full((W, 32), T, dtype=torch.long, device=dev)
    odd = (live & ~(xq.isfinite() & yq.isfinite())).any(1)
    full = odd | ~(xp.isfinite() & yp.isfinite()).all()
    if bool(full.any()):
        idx[full] = _nearest(frame, xq[full].reshape(-1), yq[full].reshape(-1)).view(-1, 32)
    fast = (~full).nonzero().squeeze(1)
    if fast.numel():
        px = padded(xp, inf, T * tile).view(T, tile)
        py = padded(yp, inf, T * tile).view(T, tile)
        box = torch.stack((px.amin(1), padded(xp, -inf, T * tile).view(T, tile).amax(1),
                           py.amin(1), padded(yp, -inf, T * tile).view(T, tile).amax(1)), 1)
        xw, yw, lw = xq[fast], yq[fast], live[fast]
        q = [torch.where(lw, t, fill).amin(1) if fill > 0 else
             torch.where(lw, t, fill).amax(1)
             for t, fill in ((xw, inf), (xw, -inf), (yw, inf), (yw, -inf))]
        gx = torch.maximum(box[None, :, 0] - q[1][:, None],
                           q[0][:, None] - box[None, :, 1]).clamp_min(0.0)
        gy = torch.maximum(box[None, :, 2] - q[3][:, None],
                           q[2][:, None] - box[None, :, 3]).clamp_min(0.0)
        first = torch.argmin(gx * gx + gy * gy, dim=1)
        order = _orders(T).to(dev)[first]                        # (F, T)
        best = torch.full(xw.shape, inf, device=dev)
        bidx = torch.full(xw.shape, 2 ** 31 - 1, dtype=torch.long, device=dev)
        seen = torch.zeros(fast.numel(), dtype=torch.long, device=dev)
        for k in range(T):
            t = order[:, k]
            b = box[t]
            dx = torch.where(xw > b[:, 1:2], xw - b[:, 1:2],
                             torch.where(xw < b[:, 0:1], b[:, 0:1] - xw, 0.0))
            dy = torch.where(yw > b[:, 3:4], yw - b[:, 3:4],
                             torch.where(yw < b[:, 2:3], b[:, 2:3] - yw, 0.0))
            need = lw & ~(dx * dx + dy * dy > best)
            rows = need.any(1).nonzero().squeeze(1)
            if not rows.numel():
                continue
            tr = t[rows]
            ex = xw[rows, :, None] - px[tr][:, None, :]
            ey = yw[rows, :, None] - py[tr][:, None, :]
            d = ex * ex + ey * ey                                  # (R, 32, tile)
            i = torch.argmin(d, dim=2)
            dmin = d.gather(2, i[..., None])[..., 0]
            j = tr[:, None] * tile + i
            cb, ci = best[rows], bidx[rows]
            take = (dmin < cb) | ((dmin == cb) & (j < ci))
            best[rows] = torch.where(take, dmin, cb)
            bidx[rows] = torch.where(take, j, ci)
            seen[rows] += 1
        idx[fast] = bidx
        visits[fast] = seen[:, None].expand(-1, 32)
    return idx.reshape(-1)[:P].view(x.shape), visits.reshape(-1)[:P].view(x.shape)
