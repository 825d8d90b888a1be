"""Kernel (h): the closed loop's local path in one launch, the path
smoother's rounds and the path parameters (CUDA source
``csrc/local_frame.cu``), its plain version and its twin.

The JAX package smooths the waypoint window and takes its path parameters
inside its jitted step (``mpc_mmd_tpu/frenet.py``: ``smooth_path`` :111, a
``lax.scan`` :134; ``path_parameters`` :148; called at
``closedloop.py:256-262``), which XLA compiles into one loop.  The plain
version is the port's chain, ``frenet.path_parameters(*frenet.smooth_path(...))``:
``maxiter`` rounds of eager operations, two (n + 1)-square matrix-vector
products a round, then the differences, the cumulative sum and the
curvature.  :func:`local_frame` runs all of it in one launch of a
thread-block cluster, every output with the chain's bits on the card:
the products in cuBLAS's gemv order and the cumulative sum in CUB's
scan order, both found by probing the H100 (``PERF.md``).
:func:`local_frame_twin` is the kernel's algorithm in tensors (those two
orders, the rounds, the NaN rule), for the tests and ``chip_smoke.py``.
``closedloop.local_problem`` takes its frame from :func:`local_frame`.
"""

from __future__ import annotations

import torch

from . import _build
from ..frenet import FrenetFrame, SmootherWorkspace, path_parameters, smooth_path

MIN_PATH = 64                  # path points: cuBLAS's blocked gemv order from 65 columns
MAX_PATH = 639                 # path points: (n + 1) / 32 chunks of a row <= 20
STRIDED_FROM = 516             # columns from which cuBLAS's gemv lanes stride
CUB_ITEMS = 15                 # CUB's items a thread in torch.cumsum of a 1-d tensor


def _check(sw: SmootherWorkspace, x_wp: torch.Tensor, y_wp: torch.Tensor) -> int:
    n = sw.num_path
    if x_wp.shape != (n,) or y_wp.shape != (n,) or sw.kkt_inv.shape != (n + 1, n + 1):
        raise ValueError(f"local_frame: x_wp and y_wp must be ({n},) and kkt_inv "
                         f"({n + 1}, {n + 1}), got {tuple(x_wp.shape)}, "
                         f"{tuple(y_wp.shape)} and {tuple(sw.kkt_inv.shape)}")
    return n


def local_frame(sw: SmootherWorkspace, x_wp: torch.Tensor, y_wp: torch.Tensor,
                threshold: float = 0.1, *, lib=None) -> FrenetFrame:
    """The :class:`FrenetFrame` of the waypoints x_wp, y_wp (n,) smoothed
    by ``sw`` within ``threshold``: ``frenet.path_parameters`` of
    ``frenet.smooth_path``.

    CPU tensors take that chain; CUDA tensors launch kernel (h) (float32,
    one device, :data:`MIN_PATH` to :data:`MAX_PATH` points, ``sw.maxiter``
    >= 1) or raise.  ``lib``: another build of the kernels' library
    (``utils/kernel_ab.py``: a variant, or its phase clock), else the
    package's.
    """
    n = _check(sw, x_wp, y_wp)
    if all(t.device.type == "cpu" for t in (sw.kkt_inv, x_wp, y_wp)):
        return path_parameters(*smooth_path(sw, x_wp, y_wp, threshold))
    kinv, x_wp, y_wp = (t.contiguous() for t in (sw.kkt_inv, x_wp, y_wp))
    _build.require_cuda_f32("local_frame", kinv, x_wp, y_wp)
    if not MIN_PATH <= n <= MAX_PATH or sw.maxiter < 1:
        raise ValueError(f"local_frame: the kernel takes {MIN_PATH} to {MAX_PATH} path "
                         f"points and at least one round, got {n} and {sw.maxiter}")
    out = torch.empty((6, n), device=x_wp.device)
    lib = lib or _build.library()
    _build.check(lib.mmd_local_frame(kinv.data_ptr(), x_wp.data_ptr(), y_wp.data_ptr(),
                                     out.data_ptr(), n, sw.maxiter, float(threshold),
                                     _build.stream()),
                 "local_frame")
    local_frame.launches += 1
    return FrenetFrame(*out.unbind(0), arc_length=out[4, -1])


local_frame.launches = 0


# ---- the twin: the kernel's algorithm in tensors ---------------------------

def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The float32 fused multiply-add a b + c, rounded once, of float32
    tensors: the product is exact in float64, the float64 sum's error is
    exact by TwoSum, and only where that sum lies exactly halfway between
    two floats does the error decide the side."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & (d == (other.double() - r.double()) / 2)
    move = tie & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(move, other, r)


def gemv_rows(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x (A (rows, K), x (K,), float32) in cuBLAS's gemv order on the
    card (``csrc/local_frame.cu``): lane l of a row's warp chains fused
    multiply-adds from +0 over its terms in turn, l, l + 32, ... from
    :data:`STRIDED_FROM` columns on, else the block T l ... T l + T - 1 (T
    = ceil(K / 32); probed from 65 columns), and the 32 partials are added
    in a tree at offsets 16, 8, 4, 2, 1."""
    rows, K = A.shape
    T = -(-K // 32)
    lane = torch.arange(32, device=A.device)
    lanes = torch.zeros((rows, 32), dtype=torch.float32, device=A.device)
    for t in range(T):
        k = lane + 32 * t if K >= STRIDED_FROM else T * lane + t
        live = k < K
        k = k[live]
        lanes[:, live] = fma32(A[:, k], x[k], lanes[:, live])
    off = 16
    while off:
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    return lanes[:, 0]


def cub_cumsum(x: torch.Tensor) -> torch.Tensor:
    """torch.cumsum of a 1-d float32 tensor in CUB's order on the card
    (``csrc/torch_order.cuh`` cub_cumsum): 15 items a thread summed in
    turn, a Kogge-Stone scan of those sums over each warp of 32, the warps'
    totals added in order, each thread's items added in turn to its
    exclusive prefix (thread 0 none)."""
    n = x.shape[0]
    threads = -(-n // (32 * CUB_ITEMS)) * 32
    pad = x[:1].expand(threads * CUB_ITEMS - n)     # CUB pads a tile with its first item
    items = torch.cat((x, pad)).view(threads, CUB_ITEMS)
    agg = items[:, 0]
    for i in range(1, CUB_ITEMS):
        agg = agg + items[:, i]
    scan = agg.view(-1, 32)
    off = 1
    while off < 32:
        scan = torch.cat((scan[:, :off], scan[:, :-off] + scan[:, off:]), dim=1)
        off *= 2
    prefix = torch.cat((scan[:, :1], scan[:, :-1]), dim=1)   # lane 0's is replaced
    block = scan[0, 31]
    rows = [prefix[0]]
    for w in range(1, scan.shape[0]):
        rows.append(torch.cat((block.view(1), block + prefix[w, 1:])))
        block = block + scan[w, 31]
    prefix = torch.cat(rows)
    run = torch.cat((items[:1, 0], prefix[1:] + items[1:, 0]))
    out = [run]
    for i in range(1, CUB_ITEMS):
        run = run + items[:, i]
        out.append(run)
    return torch.stack(out, dim=1).reshape(-1)[:n]


def local_frame_twin(sw: SmootherWorkspace, x_wp: torch.Tensor, y_wp: torch.Tensor,
                     threshold: float = 0.1) -> FrenetFrame:
    """Kernel (h)'s algorithm in tensors on any device: ``frenet.smooth_path``'s
    rounds with each product of the kept rows in :func:`gemv_rows`' order,
    then ``frenet.path_parameters`` with the cumulative sum in
    :func:`cub_cumsum`'s order.  Every elementwise step is the chain's own
    operation (the clamp keeps NaN), so on the card it carries the kernel's
    bits."""
    n = _check(sw, x_wp, y_wp)
    rows = sw.kkt_inv[:n]
    alpha = torch.zeros_like(x_wp)
    d = torch.full_like(x_wp, threshold)
    lam_x = torch.zeros_like(x_wp)
    lam_y = torch.zeros_like(x_wp)
    for _ in range(sw.maxiter):
        b_x = x_wp + d * torch.cos(alpha)
        b_y = y_wp + d * torch.sin(alpha)
        x_s = gemv_rows(rows, torch.cat((lam_x + 1.0 * b_x, x_wp[0:1])))
        y_s = gemv_rows(rows, torch.cat((lam_y + 1.0 * b_y, y_wp[0:1])))
        wc = x_s - x_wp
        wsn = y_s - y_wp
        alpha = torch.atan2(wsn, wc)
        d = torch.clamp(wc * torch.cos(alpha) + wsn * torch.sin(alpha), max=threshold)
        lam_x = lam_x - 1.0 * (wc - d * torch.cos(alpha))
        lam_y = lam_y - 1.0 * (wsn - d * torch.sin(alpha))
    Fx_dot = torch.diff(x_s)
    Fy_dot = torch.diff(y_s)
    Fx_dot = torch.cat((Fx_dot[:1], Fx_dot))
    Fy_dot = torch.cat((Fy_dot[:1], Fy_dot))
    Fx_ddot = torch.diff(Fx_dot)
    Fy_ddot = torch.diff(Fy_dot)
    Fx_ddot = torch.cat((Fx_ddot[:1], Fx_ddot))
    Fy_ddot = torch.cat((Fy_ddot[:1], Fy_ddot))
    arc = cub_cumsum(torch.sqrt(Fx_dot ** 2 + Fy_dot ** 2))
    arc_vec = torch.cat((torch.zeros_like(arc[:1]), arc[:-1]))
    kappa = (Fy_ddot * Fx_dot - Fx_ddot * Fy_dot) / ((Fx_dot ** 2 + Fy_dot ** 2) ** 1.5)
    return FrenetFrame(x_path=x_s, y_path=y_s, Fx_dot=Fx_dot, Fy_dot=Fy_dot,
                       arc_vec=arc_vec, kappa=kappa, arc_length=arc_vec[-1])
