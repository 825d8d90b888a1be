"""K1, K2, K3, K5, the Beta draw kernel (b), kernel (c), the inner CEM,
and kernels (d) and (e), the outer iteration's, built from several sources,
checked and timed in turns.

    python -m mpc_mmd_tpu_torch.utils.kernel_ab --before DIR [--diagnose] \
        [--kernels KIND_OR_BUILD ...] [--out DIR]

``--before DIR`` names a directory that holds an earlier version's
``topk.cu`` and ``eq_qp.cu`` (and, if they are there, ``topk_kernel.cu``,
``prng.cu`` and ``inner_cem.cu`` with the headers it includes, which its
build takes from DIR first), for example from ``git show
<commit>:mpc_mmd_tpu_torch/csrc/topk.cu > DIR/topk.cu``.  ``--kernels``
builds and runs only the builds of those kinds (``k1 k2 k3 prng kc kd
ke kf k4n kg kh micro``; K5 is in ``topk.cu``; ``k4n`` brings ``step_now``)
and those named (``kc_now kc_before``).
Each build's CPU seconds are logged.  Each build below
is compiled with the flags of ``ops/_build.py`` into its own shared library
under ``build/kernel_ab/`` (one ``nvcc`` per build, all started together)
and loaded with ``ctypes``; their C symbols do not clash.

Builds: ``now`` (the sources in ``csrc/``), ``before`` (DIR), and variants
of the current sources, each one textual change: ``prng_rounds2`` /
``prng_rounds5`` (kernel (b) caching two or five outer rounds of its
chains, not three), ``prng_threads128`` (its tiles of 256, not 512,
candidate elements, two a thread);
``k1_rows1`` / ``k1_rows2`` (K1 with one or two rows per warp whatever the
row count), ``k2_threads32`` (K2 with one warp a block, which keeps a
block's staging under 48 KB at every n), ``k3_global`` / ``k3_staged``
(K3 reading D from device memory at every M, or staging it in shared
memory wherever it fits), ``k3_bounds3`` (K3 at 3 blocks an SM, 85
registers a thread, not 4 and 64), ``kc_cluster1`` / ``kc_cluster2`` /
``kc_cluster4`` (kernel (c) at a forced cluster size), ``kc_warps8``
(its CTAs of 8 warps at every k), ``kc_rows2`` (two selected rows at once
in its phase B at every width), ``kc_dfirst`` (D placed first in shared
memory at every width); kernel (c)'s builds compile ``inner_cem.cu``, the
body it includes and ``inner_cem_fused.cu`` as one unit (``kc_source``),
so that a variant reaches every form; with
``--diagnose`` also ``k1_no_rounds`` (K1 loads, sorts and stores each
lane's head, no round), ``prng_no_chain`` / ``prng_no_rounds`` (kernel
(b) without its chain phase, or with no candidate entering a round),
``prng_clock`` (kernel (b) stamping each block's phases with clock64()),
``kc_clock`` / ``kc_clock_before`` (kernel (c) now and in DIR stamping
the cycles of each phase of a block with clock64()),
``k2_no_copies`` (K2 without its cp.async staging) and ``k2_no_math`` (K2
without its factorisation), whose outputs are meaningless, and a
microbenchmark of the latency of one ``redux.sync`` and one
``shfl.sync`` step (clock64 over a dependent chain of 256).

On the card, the checks: every K1 build but ``k1_no_rounds`` equals the
plain twin exactly at K1's path shapes, with an all-NaN row, NaN lanes,
ties, -0.0 against +0.0, +-inf and fewer finite lanes than k; every K2
build but the diagnostic ones is within rtol 1e-4 + atol 1e-5 of the
float64 twin at K2's path sizes (``before`` only at the sizes it was
built for), and whether ``now`` is bit-equal to ``before`` is recorded,
also on a view at an odd system offset; every K3 build gives the twin's
indices and K_red exactly at K3's shapes (M = N^2 for N = 5, 10 ... 16);
K5 of ``now`` against ``before``; kernel (b) of ``now`` bit-equal to
``before`` (NaN to NaN) and within rtol 1e-5 + atol 1e-6 of the twin
``prng.beta_draws`` at the paths' shapes (``PRNG_SHAPES``: Path A and B,
a chunk of 4, the record's N = 5 and 15, a Beta validator chunk) and at
candidates of mixed alpha (10^-8 to 10^2) at 31, 33, 100 and 400
candidates; every kernel (c) build but the clock ones bit-equal to
``kc_before`` (NaN to NaN) in all four outputs at ``KC_SHAPES`` (the seven
path shapes, gaussian and matern52, 2,048 candidates), with the cluster
size each launch took (its "xla" form; an earlier source without the
forms is called without their arguments).  With ``--kernels forms``,
kernel (c)'s forms from the package's library against their chains at
``KC_FORM_SHAPES`` (``run_forms``: every form bit-equal to its chain,
the chain timed as a graph replay, the forms' kernels in turns).  Then
the times: each build's device time per launch from ``torch.profiler``
(20 launches, 3 windows), the builds of a
shape in turns (the order reversed every other window), beside the launch
floor (``fill_`` of one float), ``torch.topk`` and, for kernel (b),
``torch._standard_gamma`` of both halves' parameters.  Kernel (d)
(``kd_now``, ``csrc/outer_project.cu``; ``kd_before`` DIR's
``outer_project.cu``, built with DIR's headers first) at ``KD_SHAPES``
(fastrt at chunks 1, 4 and 8, Path A, Path D, and the obstacle-active form
at Path D ``det`` and a straight solve with 6 obstacles; inputs from
``kd_inputs``):
each build and each forced launch choice of ``kd_now`` (``KD_CHOICES``:
one or two rows a CTA, the run-time-shape instantiation) against the plain
version (how many entries of each output are bit-equal) and bit-equal to
``kd_before`` in every output; their device times in turns three ways:
warm (back-to-back launches), L2-cold (a 64 MB buffer written between
launches) and evicted (kernel (c) at the path's shape launched between
them, as the solve's graph runs it before (d)); and ``kd_clock`` /
``kd_clock_before``: the clock64 cycles thread 0 of a block spends in each
phase of its row (``KD_PHASES``: staging, guess, polar initialisation and
unwrap, the multiplier and right-hand-side contractions, the KKT solves,
trajectory and lane rows, the polar re-estimate, the norms, the path and
the outputs).  Kernel (e) (``ke_now``, ``ke_before``) at every forced
cluster size (1, 2, 4, 8 CTAs a scenario) against its plain version and
bit-equal to ``ke_before`` at ``KE_SHAPES`` (fastrt, Path A, Path D in
``mmd_opt``, and the risk forms at Path B's ``cvar`` (also at a chunk of
4), ``saa``, ``mmd_random`` and Path D's and its ``det``; inputs from
``ke_inputs``; a form that DIR's source lacks is run by the current build
alone):
every output, the kept and elite indices and the pick included; each
size's warm device time in turns, the picked size's L2-cold and evicted
times, the size the kernel picks and the clock64 cycles of rank 0's
thread 0 between its stamps (1 risk of its share, 2 the others' risks and
the sort, 3 and 4 the lane risks and the costs as the source's
``stamp`` calls mark them, 5 elites, moments and the Cholesky factor, 6
resample and outputs).  The glue around the rollouts: kernel (f)
(``kf_now``, ``csrc/inner_prologue.cu``; also at each forced cluster
size, ``kf_now@1/2/4``) at ``KF_SHAPES``, K4n (``k4n_now``,
``csrc/rollout.cu``'s noisy-controls entry, and its ``GLUE_VARIANTS``) at
``K4N_SHAPES`` (every path shape of both) and kernel (g) (``kg_now``,
``csrc/frenet_points.cu``, and its variants ``kg_warps2`` /
``kg_warps8``, CTAs of 2 or 8 warps, and ``kg_notma``, the path staged by
the threads alone) at ``KG_SHAPES``, on a closed-loop frame (``kg_closedloop``)
and on the two inputs that visit every tile (``KG_FULL`` of ``kg_case``),
with the tiles visited a point (the twin's), and its state and obstacle
forms at Path D's states and the closed loop's obstacles where a build's
source has them (``KG_FORMS``) (inputs from ``kf_inputs``,
``k4n_inputs``, ``kg_inputs``, ``kg_state_inputs``), and DIR's builds of
them where DIR has their sources (``kf_before``, ``k4n_before``,
``kg_before``; an earlier (f) entry is called through ``SplitsEntry``, an
earlier (g) entry without the probe's outputs through ``EarlierEntry``):
each bit-equal to its plain
version in every output (else it raises), (f)'s plain D and D2 checked
bit-symmetric, K4 of every K4n build bit-equal to the first's at
``K4_SHAPES``, and their warm and L2-cold device times in turns; the
clock builds (``k4n_clock``, ``kf_clock``, ``kg_clock`` (staging, search,
wait, outputs of (g)'s point kernel) and DIR's ``*_clock_before``,
``glue_clock_variant``: the cycles of thread 0 of each block in each
phase of ``GLUE_CLOCKS``) at every shape but the forms'; kernel (h)
(``kh_now``, ``csrc/local_frame.cu``, a cluster of 16 CTAs whose warps
stage their rows of K^-1 by a bulk copy each and keep them in registers,
exchange a round's rows by one bulk copy a peer and compute their own
rows' path parameters;
``kh_runtime_t``, its terms' loop at run-time T where num_path 600
unrolls it; ``kh_pr22``, the first design, ``csrc/variants/
local_frame_pr22.cu``: a slab of K^-1 by one bulk copy a CTA, the
exchange by st.async a (row, CTA) pair, the path parameters in CTA 0
alone; ``kh_cluster8``, that design on a cluster of 8 CTAs that reads
each group from the slab each round; ``kh_before`` where DIR has it):
bit-equal to the chain (``frenet.smooth_path``, ``path_parameters``) on
``kh_window``'s windows and the closed loop's (``kh_closedloop``), timed
in turns warm and L2-cold on the closed loop's, and ``kh_clock``'s and
``kh_clock_pr22``'s (``GLUE_CLOCKS["kh"]``) cycles a phase (staging; the
wait for a round's inputs, products, update and exchange a round; the
path parameters, the slowest CTA's, with the wait for the last round's
rows, and CTA 0's scan in the current design; CTA 0's gather and path
parameters in the first); ``step_now`` (``STEP_MICRO``:
one lane's dependent chain of the rollout step alone, in cycles a step);
and each K4n, (f) and (g) build's SASS (``cuobjdump -sass``) written to
``--out``.  Each build's registers,
spills and SASS instructions per kernel (``cuobjdump -sass``) are logged.
Writes
``kernel_ab.json`` and ``kernel_ab.txt`` to ``--out`` (default
``build/kernel_ab/``).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import ctypes
import json
import os
import re
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .. import prng
from ..linalg import eq_qp_solve as qp_plain
from ..ops import _build
from ..ops.topk import topk_indices_plain
from ..ops.topk_kernel import topk_kernel_matrices_plain

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "kernel_ab"

# K1's path shapes (shape, k, absolute, ranked width m) and K2's sizes, as
# chip_smoke.py's launch_shapes gives them
K1_SHAPES = (((64, 57, 101), 10, True, 100), ((1, 64, 101), 10, True, 100),
             ((64, 64), 7, False, 64), ((100, 89, 101), 10, True, 100),
             ((1, 100, 101), 10, True, 100), ((100, 100), 11, False, 100),
             ((100, 89, 226), 15, True, 225), ((100, 89, 257), 16, True, 256))
# K2's (systems, n): the straight-road paths' at n = 10, the record's
# N = 5 and 15 cells, and the sizes past 48 KB of staging at 64 a block
K2_SIZES = ((3648, 10), (4096, 10), (8900, 10), (10000, 10), (8900, 5), (8900, 14),
            (8900, 15), (10000, 15), (8900, 16))
# K3's (C, S, M, k): the static workload's fused selection at N = 5 and
# 10 ... 16, where D[c] outgrows the staging that fits it at 4 blocks an SM
K3_SHAPES = ((100, 100, 25, 5), (100, 100, 100, 10), (100, 100, 121, 11),
             (100, 100, 144, 12), (100, 100, 169, 13), (100, 100, 196, 14),
             (100, 100, 225, 15), (100, 100, 256, 16))

# kernel (b)'s (keys, candidates, draws, P): Path A and B, a chunk of 4
# scenarios (EA4, EB4), the record's N = 5 and 15 (F5, F15), a Beta
# validator chunk; then candidates of mixed alpha
PRNG_SHAPES = ((2, 100, 500, 50), (8, 100, 500, 50), (2, 100, 250, 50),
               (2, 100, 750, 50), (512, 1, 50_000, 50))
PRNG_MIXED = ((2, 31, 500, 50), (2, 33, 500, 50), (2, 100, 500, 50), (2, 400, 500, 50))

# kernel (c)'s (C, S, k, maxiter, kernel kind), M = k^2: the seven path shapes
# chip_smoke.py times (fastrt, Path A "xla", Path D, Path F at N = 5 and 15,
# fastrt's chunks of 4 and 8 scenarios), fastrt's with the gaussian and
# matern52 kernels and 11a's chunk of 32 scenarios (2,048 candidates)
KC_SHAPES = ((64, 64, 10, 12, "laplace"), (100, 100, 10, 20, "laplace"),
             (100, 100, 4, 20, "laplace"), (100, 100, 5, 20, "laplace"),
             (100, 100, 15, 20, "laplace"), (256, 64, 10, 12, "laplace"),
             (512, 64, 10, 12, "laplace"), (64, 64, 10, 12, "gaussian"),
             (64, 64, 10, 12, "matern52"), (2048, 64, 10, 12, "laplace"))

# kernel (c)'s forms at the path shapes that run them: (path, C, S, k,
# maxiter, ((selection, elite-carry), ...)), laplace; fastrt "xla" without
# elite-carry; Path A's chunk of 4 fused (EA4); at N = 15 "xla" without
# elite-carry, whose elites run again (no path runs it); and the fused form
# at the static cells' shapes N = 11 ... 14, between Path A's M = 100 and
# F15's 225, where the form and its chain cross
KC_FORM_SHAPES = (("fastrt", 64, 64, 10, 12, (("xt", True), ("g", True), ("xla", False))),
                  ("path_a", 100, 100, 10, 20, (("fused", False), ("xt", True), ("g", True))),
                  ("path_d", 100, 100, 4, 20, (("fused", False), ("xt", True), ("g", True))),
                  ("path_e_fused4", 400, 100, 10, 20, (("fused", False),)),
                  ("path_f5", 100, 100, 5, 20, (("fused", False), ("xt", True))),
                  ("path_f15", 100, 100, 15, 20, (("fused", False), ("xt", True), ("g", True),
                                                  ("xla", False))),
                  *((f"static_n{N}", 100, 100, N, 20, (("fused", False),))
                    for N in (11, 12, 13, 14)))

# kernel (d)'s and (e)'s shapes: (workload, scenarios a chunk, on the road);
# (d)'s obstacle-active form at Path D det and a straight solve with 6
# obstacles, (e)'s risk forms at Path B's three modes (and its cvar at a
# chunk of 4) and Path D's four
KD_SHAPES = (("fastrt", 1, False), ("fastrt", 4, False), ("fastrt", 8, False),
             ("path_a", 1, False), ("path_d", 1, True), ("path_d_det", 1, True),
             ("fastrt_obs", 1, False))
KE_SHAPES = KD_SHAPES[:5] + (
    ("path_b_cvar", 1, False), ("path_b_saa", 1, False), ("path_b_mmd_random", 1, False),
    ("path_b_cvar", 4, False), ("path_d_cvar", 1, True), ("path_d_saa", 1, True),
    ("path_d_mmd_random", 1, True), ("path_d_det", 1, True))
# what a build's source must hold for a form: the obstacle-active form of
# (d), the risk forms of (e)
KD_OBS_MARKER, KE_FORMS_MARKER = "obstacle_step", "kCvar"

MICRO = r"""
#include <cuda_runtime.h>
__global__ void micro_kernel(long long* out, unsigned seed) {
  unsigned v = threadIdx.x ^ seed, w = v;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < 256; ++i) v = __reduce_max_sync(0xffffffffu, v) + threadIdx.x;
  const long long t1 = clock64();
#pragma unroll 16
  for (int i = 0; i < 256; ++i) w = __shfl_xor_sync(0xffffffffu, w, 1 + (i & 15)) + threadIdx.x;
  const long long t2 = clock64();
  if (threadIdx.x == 0) { out[0] = t1 - t0; out[1] = t2 - t1; out[2] = v + w; }
}
extern "C" int micro(long long* out, unsigned seed, void* stream) {
  micro_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, seed);
  return static_cast<int>(cudaGetLastError());
}
"""


# The critical path of one rollout step on the card: one lane (thread 0 of
# one warp, alone on its SM) runs n dependent steps of rollout.cu's step()
# from cells in shared memory, K4n's loop (a_t and tan(s_t) given) or K4's
# (tanf(s_t) in it); clock64 cycles a step.  T steps of it over the SM clock
# are a latency bound on a launch that no block shape can beat.
STEP_MICRO = r"""
#include "rollout.cu"

namespace {
template <bool K4>
__global__ void step_chain(const float* cells, int n, float dt, float wheel_base,
                           long long* out, float* sink) {
  __shared__ float a_s[256], s_s[256];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    a_s[i] = cells[i];
    s_s[i] = cells[256 + i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  State q = {0.0f, 1.75f, 5.0f, 0.0f, 0.0f};
  const WheelBase L = wheel_base_of(wheel_base);
  const long long t0 = clock64();
  for (int t = 0; t < n; ++t) {
    const float a_t = a_s[t], s_t = s_s[t];
    step(q, a_t, K4 ? tanf(s_t) : s_t, dt, L);
  }
  out[K4 ? 1 : 0] = clock64() - t0;
  sink[K4 ? 1 : 0] = q.x + q.y;
}
}  // namespace

extern "C" int mmd_step_chain(const float* cells, int n, float dt, float wheel_base,
                              long long* out, float* sink, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  step_chain<false><<<1, 32, 0, s>>>(cells, n, dt, wheel_base, out, sink);
  step_chain<true><<<1, 32, 0, s>>>(cells, n, dt, wheel_base, out, sink);
  return static_cast<int>(cudaGetLastError());
}
"""


def step_cycles(lib, n: int = 256) -> dict:
    """Clock64 cycles of one step of a lane's dependent chain (STEP_MICRO):
    K4n's (a_t, tan(s_t) formed) and K4's (tanf in the chain), at fastrt's
    dt 0.15 and wheel base 2.5, from acc 1 +- 0.5 and steer 0 +- 0.1."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = torch.cat((1.0 + 0.5 * torch.randn(256, device="cuda", generator=gen),
                       torch.tan(0.1 * torch.randn(256, device="cuda", generator=gen))))
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(2, device="cuda")
    for _ in range(2):   # the second run from a warm instruction cache
        _call(lib.mmd_step_chain(cells.data_ptr(), n, 0.15, 2.5, out.data_ptr(),
                                 sink.data_ptr(), _stream()), "step_chain")
        torch.cuda.synchronize()
    return {"k4n": out[0].item() / n, "k4": out[1].item() / n}


def _replace(src: str, old: str, new: str, name: str, count: int = -1) -> str:
    if old not in src:
        raise ValueError(f"variant {name}: its anchor is not in the source")
    return src.replace(old, new, count)


def _between(src: str, start: str, end: str, name: str):
    """(head, middle, tail) of src cut at the first ``start`` and the
    following ``end``."""
    a = src.find(start)
    b = src.find(end, a)
    if a < 0 or b < 0:
        raise ValueError(f"variant {name}: its anchors are not in the source")
    return src[:a], src[a:b], src[b:]


# kernel (b)'s phases, timed by clock64() in the prng_clock variant: the
# anchor each stamp goes before, and its name
CLOCK_STAMPS = (("  // chain phase: task", "parameters issued"),
                ("  // the candidates' constants", "chain tasks done"),
                ("  // candidate phase: the cached rounds", "barrier passed"),
                ("  // past the cached rounds", "cached rounds done"),
                ("  out_end_stamp", "output stored"))


def clock_variant(src: str) -> str:
    """Kernel (b) with each block's latest clock64() (cycles from the
    block's start) at each of CLOCK_STAMPS, read by ``mmd_prng_clock``."""
    src = _replace(src, "  const int tid = threadIdx.x;\n",
                   "  const int tid = threadIdx.x;\n  const long long c0 = clock64();\n",
                   "prng_clock")
    src = _replace(src, "beta_ratio(lg[j][0], lg[j][1]);\n  }\n}",
                   "beta_ratio(lg[j][0], lg[j][1]);\n  }\n  out_end_stamp\n}", "prng_clock")
    for i, (anchor, _) in enumerate(CLOCK_STAMPS):
        stamp = (f"  if (blockIdx.x < 4096) atomicMax(&g_clock[blockIdx.x * 8 + {i}], "
                 f"static_cast<unsigned long long>(clock64() - c0));\n")
        src = _replace(src, anchor, stamp + (anchor if i < 4 else ""), "prng_clock")
    head = "__device__ unsigned long long g_clock[4096 * 8];\n"
    tail = ("extern \"C\" int mmd_prng_clock(void* out, int reset) {\n"
            "  if (reset) return static_cast<int>(cudaMemset(g_clock_ptr(), 0, sizeof(g_clock)));\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock), 0,\n"
            "                                                cudaMemcpyDeviceToDevice));\n}\n")
    helper = ("static void* g_clock_ptr() {\n  void* p = nullptr;\n"
              "  cudaGetSymbolAddress(&p, g_clock);\n  return p;\n}\n")
    return _replace(src, "namespace {\n", head + helper + "namespace {\n", "prng_clock") + tail


# kernel (c)'s phases, timed by clock64() in the kc_clock variants: the
# anchor each region starts at, and its name; the sub-phases of E where the
# source has their anchors
KC_PHASES = (("// ---- A:", "A top-k rounds"), ("// ---- B:", "B kernel values, row sums"),
             ("// ---- C:", "C weight QP"), ("// ---- D:", "D elite pick"),
             ("// ---- E:", "E elites out, resample"))
KC_SUBPHASES = (("// ---- E1:", "E1 arrival, least cost"), ("// ---- E2:", "E2 resample"),
                ("// ---- E3:", "E3 restage"))
KC_END = "// the winner's sigma from the post-update batch"
KC_CLOCK_SLOTS = 16       # a block's stamps: its regions, and at the last the whole block
CLOCK_REGIONS = {}        # a clock build's name -> its regions, in slot order


def regions_variant(src: str, name: str, anchors, head: str, end: str, entry: str,
                    prefix: str = "kc") -> str:
    """A kernel whose block's thread 0 sums the cycles it spends in each
    region between the ``anchors`` (each (anchor, region name), a stamp
    inserted before every occurrence): slot 0 the time from ``head`` (the
    line after which the counters are declared) to the first anchor, then
    one slot an anchor, then the tail up to ``end``; the last slot the
    whole block.  The C entry ``entry(out, reset)`` copies or zeroes the
    stamps; the regions' names go to CLOCK_REGIONS[name]."""
    n = len(anchors) + 2
    acc, cur, t, t0 = (f"{prefix}_{v}" for v in ("acc", "cur", "t", "t0"))
    stamp = (f"{{{{ if (threadIdx.x == 0) {{{{ const long long n_ = clock64(); "
             f"{acc}[{cur}] += n_ - {t}; {t} = n_; {cur} = {{}}; }}}} }}}} ")
    src = _replace(src, head, head + f"  long long {acc}[{n}] = {{}};\n"
                   f"  const long long {t0} = clock64();\n  long long {t} = {t0};\n"
                   f"  int {cur} = 0;\n", name)
    for i, (anchor, _) in enumerate(anchors):
        src = _replace(src, anchor, stamp.format(i + 1) + anchor, name)
    src = _replace(src, end, stamp.format(n - 1) + (
        f"if (threadIdx.x == 0 && blockIdx.x < 4096) {{\n"
        f"    {acc}[{cur}] += clock64() - {t};\n"
        f"    for (int i_ = 0; i_ < {n}; ++i_) g_clock[blockIdx.x * {KC_CLOCK_SLOTS} + i_] = "
        f"{acc}[i_];\n"
        f"    g_clock[blockIdx.x * {KC_CLOCK_SLOTS} + {KC_CLOCK_SLOTS - 1}] = "
        f"clock64() - {t0};\n  }}\n  ") + end, name)
    head_decl = f"__device__ long long g_clock[4096 * {KC_CLOCK_SLOTS}];\n"
    helper = ("static void* g_clock_ptr() {\n  void* p = nullptr;\n"
              "  cudaGetSymbolAddress(&p, g_clock);\n  return p;\n}\n")
    tail = (f"extern \"C\" int {entry}(void* out, int reset) {{\n"
            "  if (reset) return static_cast<int>(cudaMemset(g_clock_ptr(), 0, sizeof(g_clock)));\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock), 0,\n"
            "                                                cudaMemcpyDeviceToDevice));\n}\n")
    CLOCK_REGIONS[name] = ["staging"] + [r for _, r in anchors] + ["tail"]
    ns = "namespace {\n" if "namespace {\n" in src else "namespace mmd_cem {\n"
    return _replace(src, ns, head_decl + helper + ns, name, count=1) + tail


def kc_clock_variant(src: str, name: str = "kc_clock") -> str:
    """Kernel (c) with the cycles its block's thread 0 spends in each region
    between the phase anchors of KC_PHASES (and of KC_SUBPHASES, where the
    source has them), summed over the iterations: slot 0 the staging before
    the first anchor, then one a phase, then the tail; the last slot the
    whole block.  Read by ``mmd_inner_cem_clock``; the regions' names go to
    CLOCK_REGIONS[name]."""
    anchors = list(KC_PHASES) + [a for a in KC_SUBPHASES if a[0] in src]
    return regions_variant(src, name, anchors,
                           "extern __shared__ __align__(16) float smem[];\n", KC_END,
                           "mmd_inner_cem_clock")


# kernel (d)'s phases, timed by clock64() in the kd_clock variants: the
# anchors of a source's phases (each source has one of the alternatives),
# in the order its row runs them
KD_PHASES = (("// ---- the guess QP", "guess"),
             ("// ---- the polar initialisation", "polar init + unwrap"),
             ("  residuals();\n  multipliers(false);", "pre-update"),
             ("// the right-hand sides: b vectors", "right-hand sides"),
             ("// ---- a pass: multipliers and right-hand sides", "multipliers + right-hand sides"),
             ("// rx, ry keep b_eq from the guess", "KKT"),
             ("// ---- the KKT solves", "KKT"),
             ("// the trajectory and its derivatives", "trajectory + lane rows"),
             ("// ---- the trajectory and the lane rows", "trajectory + lane rows"),
             ("    // the polar re-estimate", "polar re-estimate"),
             ("// ---- the polar re-estimate", "polar re-estimate"),
             ("    const int shift_a = ", "norms"),
             ("// ---- the norms", "norms"),
             ("    multipliers(true);", "multipliers"),
             ("// ---- the path, the controls, the outputs", "path and outputs"))
KD_HEADS = ("  extern __shared__ float sm[];\n", "  extern __shared__ __align__(128) float sm[];\n")
KD_ENDS = ("  if (lane == 0) a.res_norm[r] = rn;\n", "  // ---- the end of the row ----\n")


def kd_clock_variant(src: str, name: str = "kd_clock") -> str:
    """Kernel (d) with the cycles its block's thread 0 spends in each phase
    of its row (the KD_PHASES the source has), read by
    ``mmd_outer_project_clock``."""
    anchors = [a for a in KD_PHASES if a[0] in src]
    head = next((h for h in KD_HEADS if h in src), KD_HEADS[0])
    end = next((e for e in KD_ENDS if e in src), KD_ENDS[0])
    return regions_variant(src, name, anchors, head, end, "mmd_outer_project_clock", "kd")


# K4n's and kernel (f)'s phases, timed by clock64() in the k4n_clock and
# kf_clock variants: per kind, alternatives of (kernel start, kernel stop,
# head, ((anchor, region), ...)) within the kernel's text, the first one
# whose anchors the source has; the current sources mark their phases
# ("// ---- k4n: ..."), the earlier sources by their own lines.  A region runs
# from its anchor to the next; the first, "staging", from the head, the
# last to the stop (the kernel's end).
GLUE_CLOCKS = {
    "k4n": (("// ---- k4n: begin", "// ---- k4n: end", "// ---- k4n: begin\n",
             (("// ---- k4n: forming", "forming"), ("// ---- k4n: steps", "steps"),
              ("// ---- k4n: write-back", "write-back"))),
            ("noisy_rollout_kernel(const float* __restrict__ acc", "\n}\n\n}  // namespace",
             "  const int i = threadIdx.x;\n",
             (("  // thread i forms its own lane's controls", "forming"),
              ("  // the steps as K4 takes them", "steps"),
              ("  const int cells = nb * T;", "write-back")))),
    "kf": (("// ---- kf: begin", "// ---- kf: end", "// ---- kf: begin\n",
            (("// ---- kf: refit", "refit"), ("// ---- kf: aa", "aa"), ("// ---- kf: D", "D"))),
           ("inner_prologue_kernel(const float* __restrict__ xr", "\n}\n\nsize_t smem_bytes(",
            "  const int b = blockIdx.x, tid = threadIdx.x;\n",
            (("  // the refit of rollout m of channel ch", "refit"),
             ("  if (D2 != nullptr) {\n    for (int m = tid", "aa"),
             ("  const long long out0 =", "D")))),
}
GLUE_CLOCKS["kg"] = (("// ---- kg: begin", "// ---- kg: end", "// ---- kg: begin\n",
                      (("// ---- kg: search", "search"), ("// ---- kg: wait", "wait"),
                       ("// ---- kg: outputs", "outputs"))),)
# kernel (h): a round's phases (the first four, each entered once a round),
# then the current design's path parameters (every CTA's own rows, after
# the wait for the last round's) and CTA 0's scan of the increments, or the
# first design's gather of every row into CTA 0 and its path parameters
KH_ROUND_PHASES = ("wait", "products", "update", "exchange")
KH_TAILS = (("path parameters", "scan"), ("gather", "path parameters"))
GLUE_CLOCKS["kh"] = tuple(("// ---- kh: begin", "// ---- kh: end", "// ---- kh: begin\n",
                           tuple((f"// ---- kh: {p}", p) for p in KH_ROUND_PHASES + tail))
                          for tail in KH_TAILS)
GLUE_CLOCK_ENTRY = "mmd_glue_clock"
# variants of the current K4n source (rollout.cu: K4 with it, through the
# shared step): sinf and cosf for psi where the source takes sincosf, 32,
# 64, 128 or 160 lanes a block at every launch, the steps in 10 chunks (5
# in the source)
GLUE_VARIANTS = {"k4n": (
    ("k4n_sinf_cosf", "  float s, c;\n  sincosf(q.psi, &s, &c);",
     "  const float c = cosf(q.psi), s = sinf(q.psi);"),
    *((f"k4n_lanes{n}", "  return lanes <= kSmallLaunch ? 32 : lanes <= 2 * kSmallLaunch ? 64 : 160;",
       f"  return {n};") for n in (32, 64, 128, 160)),
    ("k4n_chunks10", "constexpr int kChunks = 5;", "constexpr int kChunks = 10;")),
    # kernel (g): CTAs of 2 or 8 warps, the path staged by the threads
    "kg": (*((f"kg_warps{n}", "constexpr int kWarps = 4;", f"constexpr int kWarps = {n};")
             for n in (2, 8)),
           ("kg_notma", "  return (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? (n & ~3) : 0;",
            "  return src ? 0 : n;"))}
# kernel (f)'s forced cluster sizes (``ops.inner_prologue``'s keyword), run
# by the current build beside its own choice
KF_CLUSTERS = (1, 2, 4)


def glue_clock_variant(kind: str, src: str, name: str):
    """K4n or kernel (f), (g) or (h) (``kind``) with the cycles thread 0 of each block
    spends in each phase of GLUE_CLOCKS (slot 0 staging, then one a phase;
    the last slot the whole block), read by ``mmd_glue_clock``; None if
    the source has no alternative's anchors."""
    for start, stop, head, anchors in GLUE_CLOCKS[kind]:
        a = src.find(start)
        b = src.find(stop, a + 1) if a >= 0 else -1
        mid = src[a:b]
        if a < 0 or b < 0 or head not in mid or any(x not in mid for x, _ in anchors):
            continue
        n = len(anchors) + 1
        stamp = ("{{ if (threadIdx.x == 0) {{ const long long n_ = clock64(); "
                 "gc_acc[gc_cur] += n_ - gc_t; gc_t = n_; gc_cur = {}; }} }} ")
        mid = mid.replace(head, head + f"  long long gc_acc[{n}] = {{}};\n"
                          "  const long long gc_t0 = clock64();\n  long long gc_t = gc_t0;\n"
                          "  int gc_cur = 0;\n", 1)
        for i, (anchor, _) in enumerate(anchors):
            mid = mid.replace(anchor, stamp.format(i + 1) + anchor)
        fin = ("\n  if (threadIdx.x == 0 && blockIdx.x < 4096) {\n"
               "    gc_acc[gc_cur] += clock64() - gc_t;\n"
               f"    for (int i_ = 0; i_ < {n}; ++i_) g_clock[blockIdx.x * {KC_CLOCK_SLOTS} + i_] "
               "= gc_acc[i_];\n"
               f"    g_clock[blockIdx.x * {KC_CLOCK_SLOTS} + {KC_CLOCK_SLOTS - 1}] = "
               "clock64() - gc_t0;\n  }\n")
        mid = mid + fin   # the kernel's end: the stop marker, or its closing brace
        decl = (f"__device__ long long g_clock[4096 * {KC_CLOCK_SLOTS}];\n"
                "static void* g_clock_ptr() {\n  void* p = nullptr;\n"
                "  cudaGetSymbolAddress(&p, g_clock);\n  return p;\n}\n")
        entry = (f"extern \"C\" int {GLUE_CLOCK_ENTRY}(void* out, int reset) {{\n"
                 "  if (reset) return static_cast<int>(cudaMemset(g_clock_ptr(), 0, "
                 "sizeof(g_clock)));\n"
                 "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clock, sizeof(g_clock), 0,\n"
                 "                                                cudaMemcpyDeviceToDevice));\n}\n")
        out = src[:a] + mid + src[b:]
        CLOCK_REGIONS[name] = ["staging"] + [r for _, r in anchors]
        return _replace(out, "namespace {\n", decl + "namespace {\n", name, count=1) + entry
    return None


KH_PR22 = _build.CSRC / "variants" / "local_frame_pr22.cu"


def kh_cluster8(src: str) -> str:
    """Kernel (h)'s first design (``KH_PR22``) on a cluster of 8 CTAs: up to 80 rows a CTA, more groups
    than warps, so a warp takes its groups in turn and reads each from the
    slab in every round."""
    name = "kh_cluster8"
    src = _replace(src, "constexpr int kCluster = 16;", "constexpr int kCluster = 8;", name)
    a, mid, b = _between(src, "static_assert(kUnit * (((kMaxN", ";\n", name)
    src = a + b[2:]
    src = _replace(src, "  const int first = kGroup * warp, count = min(kGroup, rows - first);\n"
                   "  float ak[kGroup][kMaxT];\n"
                   "  if (count > 0) load_group<TT>(ak, slab, first, count, n, L.T, base, step);\n",
                   "  const int groups = (rows + kGroup - 1) / kGroup;\n"
                   "  float ak[kGroup][kMaxT];\n", name)
    return _replace(src, "    if (count > 0) {\n",
                    "    for (int gi = warp; gi < groups; gi += kWarps) {\n"
                    "      const int first = kGroup * gi, count = min(kGroup, rows - first);\n"
                    "      load_group<TT>(ak, slab, first, count, n, L.T, base, step);\n", name)


def kc_source(csrc: Path) -> str:
    """Kernel (c)'s sources in ``csrc`` as one translation unit:
    ``inner_cem.cu`` with the body it includes (``inner_cem_body.cuh``)
    inlined and ``inner_cem_fused.cu``'s instantiations after it, where the
    directory has them (an earlier checkout's ``inner_cem.cu`` stands
    alone), so that a variant's textual change reaches every form."""
    cem = (csrc / "inner_cem.cu").read_text()
    body = csrc / "inner_cem_body.cuh"
    if not body.exists():
        return cem
    inc = '#include "inner_cem_body.cuh"\n'
    fused = (csrc / "inner_cem_fused.cu").read_text().replace(inc, "")
    return _replace(cem, inc, body.read_text().replace("#pragma once\n", ""),
                    "kc_source") + fused


def builds(before: Path, diagnose: bool = False) -> dict:
    """name -> (kind, CUDA source); kind is "k1" (topk.cu), "k2" (eq_qp.cu),
    "k3" (topk_kernel.cu), "prng" (prng.cu), "kc" (inner_cem.cu), "kd"
    (outer_project.cu), "ke" (outer_tail.cu), "kf" (inner_prologue.cu),
    "k4n" (rollout.cu), "kg" (frenet_points.cu), "kh" (local_frame.cu) or
    "micro"."""
    topk = (_build.CSRC / "topk.cu").read_text()
    qp = (_build.CSRC / "eq_qp.cu").read_text()
    fused = (_build.CSRC / "topk_kernel.cu").read_text()
    out = {"k1_now": ("k1", topk), "k1_before": ("k1", (before / "topk.cu").read_text()),
           "k2_now": ("k2", qp), "k2_before": ("k2", (before / "eq_qp.cu").read_text()),
           "k3_now": ("k3", fused),
           "prng_now": ("prng", (_build.CSRC / "prng.cu").read_text())}
    if (before / "prng.cu").exists():
        out["prng_before"] = ("prng", (before / "prng.cu").read_text())
    beta = out["prng_now"][1]
    for name, old, new in (
            ("prng_rounds2", "kRounds = 3;", "kRounds = 2;"),
            ("prng_rounds5", "kRounds = 3;", "kRounds = 5;"),
            ("prng_threads128", "kBetaThreads = 256;", "kBetaThreads = 128;")):
        out[name] = ("prng", _replace(beta, old, new, name))
    if diagnose:
        out["prng_no_chain"] = ("prng", _replace(
            beta, "t < 2 * ET * kRounds;", "t < 0 * ET * kRounds;", "prng_no_chain"))
        out["prng_no_rounds"] = ("prng", _replace(
            beta, "live[j][h] = valid[j] && rejected(", "live[j][h] = false && rejected(",
            "prng_no_rounds"))
        out["prng_clock"] = ("prng", clock_variant(beta))
    if (before / "topk_kernel.cu").exists():
        out["k3_before"] = ("k3", (before / "topk_kernel.cu").read_text())
    out["step_now"] = ("step", STEP_MICRO)
    for kind, src, entry in GLUE_SOURCES:
        out[f"{kind}_now"] = (kind, (_build.CSRC / src).read_text())
        if (before / src).exists() and entry in (before / src).read_text():
            out[f"{kind}_before"] = (kind, (before / src).read_text())
        for name, old, new in GLUE_VARIANTS.get(kind, ()):
            if old in out[f"{kind}_now"][1]:
                out[name] = (kind, _replace(out[f"{kind}_now"][1], old, new, name))
        for suffix in ("now", "before"):
            if kind in GLUE_CLOCKS and f"{kind}_{suffix}" in out:
                name = f"{kind}_clock" + ("_before" if suffix == "before" else "")
                clocked = glue_clock_variant(kind, out[f"{kind}_{suffix}"][1], name)
                if clocked is not None:
                    out[name] = (kind, clocked)
    out["kh_now"] = ("kh", (_build.CSRC / "local_frame.cu").read_text())
    # kernel (h) with the terms' loop at run-time T at every width
    out["kh_runtime_t"] = ("kh", _replace(
        out["kh_now"][1], "  const bool path = (n + 1 + kWarp - 1) / kWarp == kPathT && "
        "n + 1 >= kStridedFrom;", "  const bool path = false;", "kh_runtime_t"))
    # the first design, kept as the yardstick, and its cluster of 8
    out["kh_pr22"] = ("kh", KH_PR22.read_text())
    out["kh_cluster8"] = ("kh", kh_cluster8(out["kh_pr22"][1]))
    if (before / "local_frame.cu").exists():
        out["kh_before"] = ("kh", (before / "local_frame.cu").read_text())
    for suffix in ("now", "before", "pr22"):
        if f"kh_{suffix}" in out:
            name = "kh_clock" + ("" if suffix == "now" else f"_{suffix}")
            clocked = glue_clock_variant("kh", out[f"kh_{suffix}"][1], name)
            if clocked is not None:
                out[name] = ("kh", clocked)
    out["kd_now"] = ("kd", (_build.CSRC / "outer_project.cu").read_text())
    out["kd_clock"] = ("kd", kd_clock_variant(out["kd_now"][1]))
    out["ke_now"] = ("ke", (_build.CSRC / "outer_tail.cu").read_text())
    if (before / "outer_project.cu").exists():
        out["kd_before"] = ("kd", (before / "outer_project.cu").read_text())
        out["kd_clock_before"] = ("kd", kd_clock_variant(out["kd_before"][1],
                                                         "kd_clock_before"))
    if (before / "outer_tail.cu").exists():
        out["ke_before"] = ("ke", (before / "outer_tail.cu").read_text())
    cem = kc_source(_build.CSRC)
    out["kc_now"] = ("kc", cem)
    if (before / "inner_cem.cu").exists():
        out["kc_before"] = ("kc", kc_source(before))
        if diagnose:
            out["kc_clock_before"] = ("kc", kc_clock_variant(out["kc_before"][1],
                                                             "kc_clock_before"))
    size = re.compile(r"(int cluster_size\(.*?\) \{\n).*?\n\}", re.S)
    if not size.search(cem):
        raise ValueError("variant kc_cluster: cluster_size is not in inner_cem.cu")
    for n in (1, 2, 4):
        out[f"kc_cluster{n}"] = ("kc", size.sub(
            lambda m: m.group(1) + f"  return {n};\n}}", cem))
    rows = "return slots <= 2 ? k : slots <= 4 ? (k + 1) / 2 : 2;"
    for name, old, new in (
            ("kc_warps8", "return k <= 10 ? 16 : 8;", "return 8;"),
            ("kc_rows2", rows, "return 2;"),
            ("kc_dfirst", "const bool d_first = slots_of(M) <= 4;", "const bool d_first = true;")):
        out[name] = ("kc", _replace(cem, old, new, name))
    if diagnose:
        out["kc_clock"] = ("kc", kc_clock_variant(cem))
    staged_max = re.compile(r"constexpr int kStagedMaxM = \d+;")
    if not staged_max.search(fused):
        raise ValueError("variant k3: kStagedMaxM is not in topk_kernel.cu")
    for name, m in (("k3_global", 0), ("k3_staged", 256)):
        src = staged_max.sub(f"constexpr int kStagedMaxM = {m};", fused)
        if src != fused:                     # one of them may be the source's own
            out[name] = ("k3", src)
    out["k3_bounds3"] = ("k3", _replace(fused, "__launch_bounds__(kWarps * kWarp, 4)",
                                        "__launch_bounds__(kWarps * kWarp, 3)",
                                        "k3_bounds3"))
    rows = re.compile(r"(int launch_rows\(const Args& a, cudaStream_t stream\) \{\n).*?\n\}",
                      re.S)
    if not rows.search(topk):
        raise ValueError("variant k1_rows: launch_rows is not in topk.cu")
    for r in (1, 2):
        out[f"k1_rows{r}"] = ("k1", rows.sub(
            lambda m: m.group(1) + f"  return launch<kSlots, {r}, false>(a, stream);\n}}",
            topk))
    out["k1_slots4"] = ("k1", _replace(topk, "switch ((m + kWarp - 1) / kWarp) {",
                                       "switch (4) {", "k1_slots4"))
    out["k2_threads32"] = ("k2", _replace(qp, "constexpr int kThreads = 64;",
                                          "constexpr int kThreads = 32;", "k2_threads32"))
    if diagnose:
        out["k1_no_rounds"] = ("k1", _replace(
            topk, "for (int i = 0; i < run; ++i) {",
            "for (int r = 0; r < kRows; ++r) sel[r] = static_cast<int>(key[r][0]);\n"
            "    for (int i = 0; i < 0 * run; ++i) {", "k1_no_rounds"))
        head, copies, tail = _between(qp, "  const float* Cg = C + s0 * L::kC;",
                                      "  mmd_async::commit();", "k2_no_copies")
        out["k2_no_copies"] = ("k2", head + "  if (batch < 0) {\n" + copies + "  }\n" + tail)
        # solve_system (qp_system.cuh) replaced in both entries
        no_math = ("template <int N>\n__device__ __forceinline__ float no_math("
                   "float (&a)[N][N], const float (&rv)[N], float (&bv)[N]) {\n"
                   "#pragma unroll\n  for (int i = 0; i < N; ++i) bv[i] = rv[i] + a[i][i];\n"
                   "  return 0.0f;\n}\n\n")
        call = "const float m = solve_system<N>(a, rv, bv);"
        if qp.count(call) != 2:
            raise ValueError("variant k2_no_math: its anchors are not in the source")
        out["k2_no_math"] = ("k2", _replace(
            qp, "template <int N>\n__global__ void __launch_bounds__(Layout<N>::kSystems)",
            no_math + "template <int N>\n__global__ void __launch_bounds__("
            "Layout<N>::kSystems)", "k2_no_math").replace(
                call, "const float m = no_math<N>(a, rv, bv);"))
        out["micro"] = ("micro", MICRO)
    return out


def build_all(sources: dict, log, before: Path = None) -> dict:
    """Compiles every source at once; name -> loaded library.  Kernel (c)'s
    builds of ``before`` take their headers from that directory first."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (kind, src) in sources.items():
        SOURCES[name] = src
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(src)
        own = (["-I", str(before)] if kind in ("kc", "kd", "ke", "kf", "k4n", "kg", "kh")
               and name.endswith("_before") else [])
        cmd = [nvcc, *_build.NVCC_FLAGS, *own, "-I", str(_build.CSRC), "-shared", "-o",
               str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (so, proc) in procs.items():
        text = proc.stdout.read()
        # the resources of nvcc and of the compilers it waited for
        _, status, use = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        log(f"built {name} in {use.ru_utime + use.ru_stime:.1f} CPU s: registers "
            f"{re.findall(r'Used (\d+) registers', text)}, stack "
            f"frames {re.findall(r'(\d+) bytes stack frame', text)}, spill stores "
            f"{re.findall(r'(\d+) bytes spill stores', text)}")
        kind = sources[name][0]
        if kind in ("kd", "ke"):
            RESOURCES[name] = resources(text, so)
            for fn, r in RESOURCES[name].items():
                log(f"  {name} {fn}: {r}")
        lib = ctypes.CDLL(str(so))
        if kind == "micro":
            lib.micro.argtypes = [P, ctypes.c_uint, P]
        elif kind == "step":
            lib.mmd_step_chain.argtypes = [P, I, ctypes.c_float, ctypes.c_float, P, P, P]
        elif kind == "k1":
            lib.mmd_topk_indices.argtypes = [P, P, I, I, I, I, I, P]
            lib.mmd_topk_onehot.argtypes = [P, P, P, I, I, I, I, I, P]
        elif kind == "k3":
            lib.mmd_topk_kernel_matrices.argtypes = [P, ctypes.c_longlong, P, P, P, P,
                                                     I, I, I, I, P]
        elif kind == "kc":
            # an earlier source's entry lacks the form, recompute and g_block
            forms = "long long g_block" in sources[name][1]
            sig = _build._SIGNATURES["mmd_inner_cem"]
            lib.mmd_inner_cem.argtypes = sig if forms else sig[:22] + sig[-1:]
            lib.mmd_inner_cem_scratch.argtypes = _build._SIGNATURES[
                "mmd_inner_cem_scratch"][:7 if forms else 5]
            lib.kc_forms = forms
            if name.startswith("kc_clock"):
                lib.mmd_inner_cem_clock.argtypes = [P, I]
        elif kind in ("kd", "ke"):
            entry = {"kd": "mmd_outer_project", "ke": "mmd_outer_tail"}[kind]
            sig = list(_build._SIGNATURES[entry])
            current, later = LATER_ARGS[kind]
            now = (_build.CSRC / current).read_text()
            drop = tuple(d for marker, at in later
                         if marker not in sources[name][1] and marker in now for d in at)
            earlier = bool(drop)
            if earlier:
                sig = [t for i, t in enumerate(sig) if i not in {d % len(sig) for d in drop}]
            getattr(lib, entry).argtypes = sig
            getattr(lib, entry).restype = ctypes.c_int
            if kind == "ke":
                lib.mmd_outer_tail_cluster.argtypes = [I]
            if name.startswith("kd_clock"):
                lib.mmd_outer_project_clock.argtypes = [P, I]
            if earlier:
                lib = EarlierEntry(lib, entry, drop)
        elif kind in GLUE_ENTRIES:
            fn = getattr(lib, GLUE_ENTRIES[kind])
            fn.argtypes = _build._SIGNATURES[GLUE_ENTRIES[kind]]
            fn.restype = ctypes.c_int
            # an earlier (g) entry lacks the probe's idx and visits
            earlier_kg = kind == "kg" and KG_PROBE not in sources[name][1]
            if earlier_kg:
                fn.argtypes = [t for i, t in enumerate(fn.argtypes) if i not in KG_PROBE_AT]
            if kind == "k4n":
                lib.mmd_fused_rollout.argtypes = _build._SIGNATURES["mmd_fused_rollout"]
            for extra in KG_FORMS if kind == "kg" else ():
                if extra in sources[name][1]:
                    getattr(lib, extra).argtypes = _build._SIGNATURES[extra]
                    getattr(lib, extra).restype = ctypes.c_int
            # an earlier obstacle entry lacks the trajectories' t, traj and num
            earlier_ko = (kind == "kg" and KG_FORMS[1] in sources[name][1]
                          and KG_TRAJ not in sources[name][1])
            if earlier_ko:
                fn_o = getattr(lib, KG_FORMS[1])
                fn_o.argtypes = [t for i, t in enumerate(fn_o.argtypes) if i not in KG_TRAJ_AT]
            if "_clock" in name:
                getattr(lib, GLUE_CLOCK_ENTRY).argtypes = [P, I]
            if kind in ("k4n", "kf", "kg"):
                dump_sass(so, OUT_DIR / f"{name}.sass")
            if kind == "kf" and "int splits" in sources[name][1]:
                lib = SplitsEntry(lib)
            if earlier_kg:
                lib = EarlierEntry(lib, GLUE_ENTRIES[kind], KG_PROBE_AT)
            if earlier_ko:
                lib = EarlierEntry(lib, KG_FORMS[1], KG_TRAJ_AT)
        elif kind == "kh":
            lib.mmd_local_frame.argtypes = _build._SIGNATURES["mmd_local_frame"]
            lib.mmd_local_frame.restype = ctypes.c_int
            if "_clock" in name:
                getattr(lib, GLUE_CLOCK_ENTRY).argtypes = [P, I]
            dump_sass(so, OUT_DIR / f"{name}.sass")
        elif kind == "prng":
            L = ctypes.c_longlong
            lib.mmd_prng_beta.argtypes = [P, P, P, L, L, L, L, P, P]
            if name == "prng_clock":
                lib.mmd_prng_clock.argtypes = [P, I]
        else:
            lib.mmd_eq_qp_solve.argtypes = [P, P, P, P, I, I, P]
        libs[name] = lib
    return libs


RESOURCES = {}     # a kd / ke build's name -> its kernels' registers, spills, SASS size
SOURCES = {}       # a build's name -> its CUDA source


class EarlierEntry:
    """An earlier build whose C entry lacks arguments that the current
    wrapper passes (kernel (d)'s launch choices, kernel (e)'s kept_cta,
    kernel (g)'s probe outputs):
    its calls drop the arguments at the positions ``drop`` (negative from
    the end)."""

    def __init__(self, lib, entry: str, drop):
        self._lib, self._entry, self._drop = lib, entry, drop

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != self._entry:
            return fn
        return lambda *args: fn(*(a for i, a in enumerate(args)
                                  if i not in {d % len(args) for d in self._drop}))


def parent_splits(B: int, M: int, sms: int) -> int:
    """The earlier launch choice of kernel (f) (``ops.inner_prologue
    .splits_for``): CTAs a candidate's rows of D went to, enough for two
    on each multiprocessor, at least 16 rows each."""
    return max(1, min(-(-2 * sms // B), -(-M // 16)))


class SplitsEntry:
    """An earlier build of kernel (f), whose entry took ``splits`` where
    the current one takes the cluster size: its calls pass that build's
    own choice (:func:`parent_splits`) in its place."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "mmd_inner_prologue":
            return fn
        sms = torch.cuda.get_device_properties(0).multi_processor_count

        def call(*args):
            args = list(args)
            args[-2] = parent_splits(args[8], args[9], sms)
            return fn(*args)
        return call


# per kind: the current source, and each argument an earlier entry may lack
# (a name the source has with it) with its positions in the current entry
LATER_ARGS = {"kd": ("outer_project.cu", (("rows_per_cta", (-13, -12)),
                                          ("per_scen", tuple(range(-11, -1))))),
              "ke": ("outer_tail.cu", (("kept_cta", (31,)),
                                       ("q_lo_des", (44, -8, -7, -6, -5, -4, -3, -2))))}


def resources(ptxas: str, so: Path) -> dict:
    """Per kernel of a build: registers, stack frame and spill stores from
    ``-Xptxas -v``'s output, and its SASS instructions from ``cuobjdump
    -sass`` where the toolkit has it."""
    out, cur = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if tool.exists():
        sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                              text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn in out and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                out[fn]["sass_instructions"] = out[fn].get("sass_instructions", 0) + 1
    return out


def dump_sass(so: Path, path: Path) -> None:
    """``cuobjdump -sass`` of a build, where the toolkit has it."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if tool.exists():
        path.write_text(subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                                       text=True).stdout)


def device_ms(fn, match: str, reps: int = 20) -> float:
    """Device milliseconds per call: the device events whose name holds
    ``match`` in a profiled window of ``reps`` calls, which should number at
    least ``reps`` (a library call may launch several kernels).  The
    profiler now and then records no device event in a session, or drops
    launches' records: as in chip_smoke.py's ``profiled_ms``, each session
    opens with a short ``spin_kernel`` left out of the count, and of ten
    sessions the first full one counts, else the fullest, per recorded
    event, if it holds at least half of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name
              and "spin_kernel" not in e.name]
        if len(ev) >= reps:
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps
        best = max(best, ev, key=len)
    if 2 * len(best) < reps:
        raise RuntimeError(f"profiler: {len(best)} device events named {match!r} for "
                           f"{reps} calls")
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / len(best)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def k1_inputs(gen, shape, k, absolute):
    """Random rows with the edge rows of the module docstring; the elite
    pick's rows are -cost.  On the generator's device, as the other
    builders here."""
    x = torch.randn(shape, device=gen.device, generator=gen)
    flat = x.view(-1, shape[-1])
    flat[0] = float("nan")
    flat[1, ::3] = float("nan")
    flat[2] = torch.round(flat[2] * 2) / 2
    flat[3] = 0.0
    flat[3, ::2] = -0.0
    flat[4, 5 % shape[-1]], flat[4, 7 % shape[-1]] = float("inf"), -float("inf")
    flat[5, :shape[-1] - k + 2] = float("nan")
    return x if absolute else -x


def k2_inputs(gen, batch, n=10):
    """Systems as the inner CEM builds them (rho K + reg I, Laplace K)."""
    f = torch.randn(batch, n, 22, device=gen.device, generator=gen)
    d = (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1)
    sigma = torch.rand(batch, 1, 1, device=gen.device, generator=gen) * 10 + 0.01
    K = torch.exp(-d / sigma)
    return ((K + 0.05 * torch.eye(n, device=gen.device)).contiguous(),
            (K.sum(-1) / 100.0).contiguous())


def k3_inputs(gen, C, S, M):
    """Samples (C, S, M+1) with a NaN lane and tied |beta|, D from random
    features, as chip_smoke.py checks K3."""
    samples = torch.randn(C, S, M + 1, device=gen.device, generator=gen)
    samples[..., M] = samples[..., M].abs() * 3 + 0.01
    samples[0, 1, 7 % M] = float("nan")
    samples[0, 2, :M] = torch.round(samples[0, 2, :M])
    f = torch.randn(C, M, 22, device=gen.device, generator=gen)
    return samples, (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1).contiguous()


def kc_inputs(gen, C, S, k, maxiter, kind="laplace", inf_lane=False, full=False,
              edges=True):
    """Kernel (c)'s inputs at C candidates, S samples, k = num_reduced (M =
    k^2 mother rollouts) and maxiter iterations, as chip_smoke.py checks
    it: ``reduced_set.inner_inputs`` of mother rollouts with random
    coefficients and of random draws, the first batch's row 1 with a NaN
    lane and its row 2 with tied |beta| (and with ``inf_lane`` its row 3
    with an infinite lane, which wins every round of the "fused" form's
    top-k); with ``edges`` false none of these (the inputs a form is timed
    on: under "fused" a row with a NaN lane selects the sentinel and wins,
    and the NaN reaches every fresh row, whose rounds are then skipped).
    Returns (inputs, n_el, rho, reg), and with ``full`` also the
    configuration and the coefficients cx, cy (C, M, 11) whose L1
    distances are D."""
    import dataclasses
    from ..config import static_workload
    from ..noise import InnerDraws
    from ..reduced_set import inner_inputs
    cfg = static_workload(num_reduced=k)
    cfg = cfg.replace(risk=dataclasses.replace(cfg.risk, kernel=kind),
                      beta_cem=dataclasses.replace(cfg.beta_cem, num_samples_cem=S,
                                                   maxiter=maxiter))
    b, M = cfg.beta_cem, k * k
    n_el = b.num_ellite
    draws = InnerDraws(*(torch.randn(shape, device=gen.device, generator=gen)
                         for shape in ((S, M + 1), (maxiter, S - n_el, n_el),
                                       (maxiter, S - n_el, M + 1))))
    if edges:
        draws.samples0[1, 7 % M] = float("nan")
        draws.samples0[2, :M] = torch.round(draws.samples0[2, :M])
    if edges and inf_lane:
        draws.samples0[3, 11 % M] = float("inf")
    # coefficients at a spread whose kernel values lie between 0 and 1
    cx, cy = (0.3 * torch.randn(C, M, 11, device=gen.device, generator=gen)
              for _ in range(2))
    out = (inner_inputs(cfg, cx, cy, draws), n_el, b.rho_beta, b.qp_reg)
    return out + (cfg, cx, cy) if full else out


def kd_inputs(gen, cfg, N: int, path: bool = False):
    """Kernel (d)'s inputs for a chunk of N scenarios of ``cfg``'s
    candidates, on the generator's device: the initial batch of chip_smoke's
    mean and covariance from normal draws, row 1's desired speeds at 100
    m/s (past v_max: the polar clip saturates), the boundary rows of
    chip_smoke's initial state, the multipliers and lane slack that the
    plain version leaves after one iteration from zero (the state a second
    outer iteration carries) and N scenarios' obstacles (which set the
    plain version's scenario count: two, or with the obstacle terms the
    configuration's num_obs, on the candidates' way); with ``path`` a
    curved path of 600 points.  Returns (args, kwargs) of
    ``ops.outer_project``."""
    from ..ops.outer_project import outer_project_plain
    from ..qp import boundary_vectors, build_workspace
    from ..sampling import initial_params
    dev = gen.device
    ws = build_workspace(cfg, dev)
    rows = N * cfg.cem.num_batch
    mean = torch.tensor([15.0] * 4 + [0.0] * 4, device=dev)
    cov = torch.diag(torch.tensor([20.0] * 4 + [100.0] * 4, device=dev))

    def batch():
        p = initial_params(cfg, mean, cov, torch.randn(rows, 8, device=dev, generator=gen))
        p[1, :4] = 100.0
        return p

    bx, by = boundary_vectors(cfg, torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0, 0.0], device=dev))
    bx, by = bx.repeat(N, 1), by.repeat(N, 1)
    t = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device=dev)
    n_obs = cfg.obstacles.num_obs if cfg.projection.with_obstacle_terms else 2
    lanes = torch.tensor([1.75, -1.75], device=dev)[torch.arange(N * n_obs, device=dev) % 2]
    kw = dict(x_obs=torch.stack([30.0 + 8.0 * t + 5.0 * o for o in range(N * n_obs)]
                                ).reshape(N, n_obs, -1),
              y_obs=(lanes[:, None] * torch.ones_like(t)).reshape(N, n_obs, -1)
              if n_obs != 2 else torch.full((N, 2, cfg.horizon.num), 1.75, device=dev))
    if path:
        s = torch.linspace(0.0, 300.0, 600, device=dev)
        kw.update(arc_vec=s, kappa=0.01 * torch.sin(s / 30.0))
    nvar, nl = cfg.horizon.nvar, 2 * (cfg.horizon.num - 1)
    zero = lambda n: torch.zeros(rows, n, device=dev)
    first = outer_project_plain(cfg, ws, batch(), bx, by, zero(nvar), zero(nvar), zero(nl),
                                **kw)
    return (cfg, ws, batch(), bx, by, first.lamda_x, first.lamda_y, first.s_lane), kw


def ke_inputs(gen, cfg, N: int, frenet: bool = False, nonpd: bool = False):
    """Kernel (e)'s inputs for a chunk of N scenarios of ``cfg`` in its
    risk mode, on the generator's device: a projection of ``kd_inputs``'
    rows by the plain version, its residual order, reduced rollouts around
    the candidates' trajectories, weights and bandwidths (in ``mmd_random``
    the uniform ones the solvers give it; None where the mode reads none,
    and in ``det`` no rollouts either), six obstacles along the candidates'
    mean path, normal resample draws, chip_smoke's moments (with ``nonpd``
    a covariance that is not positive definite, whose resample is NaN).
    Every scenario's candidate 3 has a NaN in a rollout and candidate 7
    rollouts far from every obstacle and inside the lanes (no violation).
    The plain tail's best elite of scenario 0 is copied to its last
    position, so that the kept and the elites hold a tie in risk and in
    cost.  Returns the arguments of ``ops.outer_tail``."""
    from ..ops.outer_project import outer_project_plain
    from ..ops.outer_tail import outer_tail_plain
    from ..risk import uniform_weights
    dev = gen.device
    args, kw = kd_inputs(gen, cfg, N, frenet)
    pj = outer_project_plain(*args, **kw)
    nb, num = cfg.cem.num_batch, cfg.horizon.num
    R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
    order = torch.argsort(pj.res_norm.reshape(N, nb), dim=1, stable=True)
    per = torch.arange(N, device=dev)[:, None]
    traj = lambda t: t.reshape(N, nb, num)[per, order][..., None, :T]
    noise = lambda s: s * torch.randn(N, nb, R, T, device=dev, generator=gen)
    x_roll, y_roll = traj(pj.x) + noise(1.0), traj(pj.y) + noise(0.5)
    beta = torch.rand(N, nb, R, device=dev, generator=gen) + 0.1
    beta = beta / beta.sum(dim=-1, keepdim=True)
    sigma = 0.5 + torch.rand(N, nb, device=dev, generator=gen)
    mode = cfg.risk.mode
    if mode == "mmd_random":
        beta, sigma = uniform_weights(cfg, (N, nb), dev)
    elif mode != "mmd_opt":          # cvar, saa and det read no weights
        beta = sigma = None
    if nb > 7:
        x_roll[:, 3, 0, T // 2] = float("nan")
        x_roll[:, 7] = x_roll[:, 7] + 1.0e4
        y_roll[:, 7] = 0.5 * (cfg.lane.y_lb + cfg.lane.y_ub)
    mid = pj.x.reshape(N, nb, num).mean(dim=1)                       # (N, num)
    x_obs = torch.stack([mid + 4.0 * o - 10.0 for o in range(6)], dim=1)
    y_obs = torch.tensor([-1.75, 1.75, 0.0, -1.75, 1.75, 0.0], device=dev)[None, :, None]
    y_obs = y_obs.expand(N, 6, num).contiguous()
    z = torch.randn(N, nb - cfg.cem.ellite_num, 8, device=dev, generator=gen)
    mean = torch.tensor([15.0] * 4 + [0.0] * 4, device=dev).expand(N, 8).contiguous()
    cov = torch.diag(torch.tensor([20.0] * 4 + [100.0] * 4, device=dev)).expand(N, 8, 8)
    cov = (-cov if nonpd else cov).contiguous()
    v_des = torch.tensor(15.0, device=dev)
    res = torch.zeros(N, cfg.cem.maxiter_cem, device=dev)
    if mode == "det":
        x_roll = y_roll = None
    out = [cfg, frenet, pj, order, args[2].reshape(N, nb, 8), beta, sigma, x_roll, y_roll,
           x_obs, y_obs, z, mean, cov, v_des, res, res.clone(), 1]
    tail = outer_tail_plain(*out[:15], res.clone(), res.clone(), 1)
    best, last = int(tail.kept[0, int(tail.elites[0, 0])]), nb - 1
    rows = pj._asdict()
    for name in ("y", "xdot", "ydot", "xddot", "yddot", "res_norm", "steer",
                 "steering", "kappa_interp"):
        t = rows[name].clone()
        t[int(order[0, last])] = t[int(order[0, best])]
        rows[name] = t
    out[2] = type(pj)(**rows)
    out[4] = out[4].clone()
    out[4][0, int(order[0, last])] = out[4][0, int(order[0, best])]
    for i in (5, 6, 7, 8):
        if out[i] is not None:
            out[i][0, last] = out[i][0, best]
    return out


def _trajectories(gen, lead, T: int, dt: float):
    """Positions x, y (*lead, T) of rollouts at a speed of 5 to 15 m/s with
    a random walk in acceleration and lateral drift, on the generator's
    device."""
    dev = gen.device
    v = 5.0 + 10.0 * torch.rand(*lead, 1, device=dev, generator=gen)
    a = torch.cumsum(0.3 * torch.randn(*lead, T, device=dev, generator=gen), dim=-1)
    t = dt * torch.arange(T, device=dev)
    x = v * t + torch.cumsum(a * dt * dt, dim=-1)
    y = 1.75 * torch.randn(*lead, 1, device=dev, generator=gen) + torch.cumsum(
        0.05 * torch.randn(*lead, T, device=dev, generator=gen), dim=-1)
    return x, y


def kf_inputs(gen, cfg, N: int, kind: str = "laplace"):
    """Kernel (f)'s inputs for a chunk of N scenarios of ``cfg`` (mmd_opt),
    on the generator's device: the workspace and N x num_batch candidates'
    num_mother rollouts of num_prime steps (``_trajectories``).  Returns
    the arguments of ``ops.inner_prologue``."""
    from ..qp import build_workspace
    ws = build_workspace(cfg, gen.device)
    lead = (N, cfg.cem.num_batch, cfg.risk.num_mother)
    xr, yr = _trajectories(gen, lead, cfg.horizon.num_prime, cfg.horizon.dt)
    return ws, xr, yr, kind


def k4n_inputs(gen, cfg, N: int, frenet: bool = False, const: float = 0.0):
    """K4n's inputs for a chunk of N scenarios of ``cfg``, on the
    generator's device: controls (N, num_batch, T) with exact zeros (steer
    at t = 0, acc at the last step, as every solve has), the iteration's
    draws (standard normals shared by a scenario's candidates, or Beta
    draws in (0, 1) a candidate), eps_const, and one initial state or, with
    ``frenet``, a state per rollout of a candidate; ``const`` the acc and
    steer const noise.  Returns the arguments of ``ops.noisy_rollout``."""
    import dataclasses
    dev = gen.device
    C, R, T = cfg.cem.num_batch, cfg.risk.num_reduced, cfg.horizon.num_prime
    mother = cfg.risk.mode == "mmd_opt"
    acc = 1.0 + 0.5 * torch.randn(N, C, T, device=dev, generator=gen)
    steer = 0.1 * torch.randn(N, C, T, device=dev, generator=gen)
    acc[..., -1] = 0.0
    steer[..., 0] = 0.0
    if cfg.noise.kind == "gaussian":
        d_acc, d_steer = (torch.randn(N, 1, R, T, device=dev, generator=gen)
                          for _ in range(2))
    else:
        d_acc, d_steer = (torch.rand(N, C, R, T, device=dev, generator=gen)
                          for _ in range(2))
    eps = torch.randn(N, 1, R, T, device=dev, generator=gen)
    s0 = torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device=dev)
    if frenet:
        per = R * R if mother else R
        s0 = s0 + torch.tensor([0.5, 0.3, 0.5, 0.1, 0.02], device=dev) * torch.randn(
            per, 5, device=dev, generator=gen)
    noise = dataclasses.replace(cfg.noise, acc_const=const, steer_const=const)
    return (acc, steer, d_acc, d_steer, eps, s0, noise, cfg.horizon.dt,
            cfg.vehicle.wheel_base, mother)


def kg_frame(dev, n: int = 600):
    """The Frenet frame of a curved path of n points over 300 m (a left
    bend and a right one), on ``dev``."""
    from ..frenet import path_parameters
    s = torch.linspace(0.0, 300.0, n, device=dev)
    return path_parameters(s, 20.0 * torch.sin(s / 60.0))


def kg_inputs(gen, cfg, N: int = 1):
    """Kernel (g)'s inputs for ``cfg``'s N x num_batch candidates' R
    rollouts of num_prime steps around ``kg_frame``'s path, on the
    generator's device, with edge points in scenario 0's first candidate:
    a point equidistant from two path points, points before the path's
    start and past its end, a point on the last path point and a NaN.
    Returns (frame, x, y), the arguments of ``ops.frenet_points``."""
    dev = gen.device
    frame = kg_frame(dev)
    lead = (N, cfg.cem.num_batch, cfg.risk.num_reduced)
    x, y = _trajectories(gen, lead, cfg.horizon.num_prime, cfg.horizon.dt)
    y = y + 20.0 * torch.sin(x / 60.0)
    xp, yp = frame.x_path, frame.y_path
    edge = [((xp[10] + xp[11]) / 2, (yp[10] + yp[11]) / 2), (xp[0] - 5.0, yp[0]),
            (xp[-1] + 5.0, yp[-1] + 1.0), (xp[-1], yp[-1]),
            (torch.tensor(float("nan"), device=dev), yp[3])]
    for i, (ex, ey) in enumerate(edge):
        x[0, 0, 0, i], y[0, 0, 0, i] = ex, ey
    return frame, x, y


# Kernel (g)'s adversarial inputs (``kg_case``): ties, points far off the
# path, squares that overflow, non-finite points and path points, duplicate
# path points, ragged sizes; and at Path D's 20,000 points the two that
# make every warp visit every tile (``KG_FULL``)
KG_CASES = ("tie_across_a_tile_boundary", "tie_between_non_adjacent_tiles",
            "far_off_the_path", "squares_overflow", "non_finite_query", "nan_path_point",
            "inf_path_point", "duplicate_path_points", "path_shorter_than_a_tile",
            "ragged_sizes", "circle_centre", "all_non_finite")
KG_FULL = ("circle_centre", "all_non_finite")


def kg_case(name: str, dev="cpu"):
    """(frame, x, y) of kernel (g)'s adversarial input ``name`` on ``dev``:
    the frame ``frenet.path_parameters`` of the case's path, the points
    1-d.  Made from a numpy generator of its own (seed 31)."""
    from ..frenet import path_parameters
    rng = np.random.default_rng(31)
    line = lambda n: (np.arange(n, dtype=np.float32), np.zeros(n, np.float32))

    def curvy(n):
        t = np.linspace(0.0, 1.0, n)
        return 300.0 * t, 8.0 * np.sin(2.0 * np.pi * t) + 20.0 * t * t

    if name == "tie_across_a_tile_boundary":
        # (31.5, 0.75) is as far from points 31 and 32, the last of tile 0
        # and the first of tile 1
        xp, yp = line(100)
        px = np.concatenate(([31.5, 15.5, 63.5], rng.uniform(0, 99, 40)))
        py = np.concatenate(([0.75, -2.0, 0.0], rng.normal(0, 1, 40)))
    elif name == "tie_between_non_adjacent_tiles":
        # a U: out along y = 0 (points 0-49), back along y = 2 (50-99); the
        # warp starts at the return leg's tile, and (10, 1) ties points 10
        # and 89, two tiles apart, where the first tile's bound equals the best
        xp = np.concatenate((np.arange(50), 99 - np.arange(50, 100)))
        yp = np.concatenate((np.zeros(50), np.full(50, 2.0)))
        px = np.concatenate(([10.0], 10.0 + rng.uniform(-0.4, 0.4, 31)))
        py = np.concatenate(([1.0], np.full(31, 1.9)))
    elif name == "far_off_the_path":
        xp, yp = curvy(300)
        px, py = rng.uniform(-1e4, 1e4, 70), rng.uniform(-1e4, 1e4, 70)
    elif name == "squares_overflow":
        xp, yp = line(90)
        xp = xp * 1e18
        px = np.concatenate((np.full(32, 3e19), rng.uniform(-1e20, 1e20, 40)))
        py = np.concatenate((np.full(32, 2e19), rng.uniform(-3e19, 3e19, 40)))
    elif name == "non_finite_query":
        xp, yp = curvy(200)
        px, py = rng.uniform(0, 300, 96), rng.uniform(-5, 30, 96)
        px[5], py[40], px[70], py[70] = np.nan, np.inf, -np.inf, np.nan
    elif name in ("nan_path_point", "inf_path_point"):
        xp, yp = curvy(200)
        if name == "nan_path_point":
            yp[37] = np.nan
        else:
            xp[37], xp[150] = np.inf, -np.inf
        px, py = rng.uniform(0, 300, 64), rng.uniform(-5, 30, 64)
        px[3] = np.inf
    elif name == "duplicate_path_points":
        xp, yp = (np.repeat(a, 3) for a in curvy(60))
        px = np.concatenate((xp[::7], rng.uniform(0, 300, 20)))
        py = np.concatenate((yp[::7] + 0.25, rng.uniform(-5, 30, 20)))
    elif name == "path_shorter_than_a_tile":
        xp, yp = curvy(5)
        px, py = rng.uniform(-10, 310, 37), rng.uniform(-5, 30, 37)
    elif name == "ragged_sizes":
        xp, yp = curvy(45)
        px, py = rng.uniform(-10, 310, 77), rng.uniform(-5, 30, 77)
    elif name == "circle_centre":
        # every tile's bound is the radius squared: every warp visits all
        th = np.linspace(0.0, 2.0 * np.pi, 600)
        xp, yp = 50.0 * np.cos(th), 50.0 * np.sin(th)
        px, py = rng.normal(0, 1e-3, 20_000), rng.normal(0, 1e-3, 20_000)
    elif name == "all_non_finite":
        xp, yp = curvy(600)
        px, py = np.full(20_000, np.nan), rng.uniform(-5, 30, 20_000)
    else:
        raise ValueError(f"kg_case: no case {name!r}")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return path_parameters(f32(xp), f32(yp)), f32(px), f32(py)


def kg_closedloop(gen, cfg, arc: float = 150.0, N: int = 1):
    """Kernel (g)'s inputs on a closed-loop frame: ``closedloop.local_problem``'s
    frame (kernel (h)'s, ``ops.local_frame``; its chain on the CPU) with the
    ego ``arc`` metres along ``run_episode``'s curved route (ego-shifted:
    the ego at the origin, its heading the route's), and
    ``cfg``'s N x num_batch x R rollouts of num_prime steps from the ego
    along that heading (``_trajectories``), on the generator's device.
    Returns (frame, x, y) and the obstacles' rows (num_obs, 5) of
    ``local_problem`` there, the obstacle form's input."""
    from ..closedloop import SyntheticPlant, make_route, perceive_obstacles
    from ..ops.local_frame import local_frame
    dev = gen.device
    plant = SyntheticPlant(cfg, make_route("curved"), ((arc + 12.0, 0.5), (arc + 40.0, 3.0)))
    sp = plant.spline
    plant.state = np.array([float(sp.cs_x(arc)), float(sp.cs_y(arc)), 8.0,
                            float(sp.cs_phi(arc)), 0.0])
    x_e, y_e, _, psi_e, _ = plant.state
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    frame = local_frame(*kh_closedloop(cfg, dev, arc), cfg.frenet.smooth_threshold)
    lead = (N, cfg.cem.num_batch, cfg.risk.num_reduced)
    u, w = _trajectories(gen, lead, cfg.horizon.num_prime, cfg.horizon.dt)
    w = w - w[..., :1]                      # every rollout from the ego
    c, s = float(np.cos(psi_e)), float(np.sin(psi_e))
    obs = perceive_obstacles(cfg, plant, (x_e, y_e), psi_e).copy()
    obs[:, 0] -= x_e
    obs[:, 1] -= y_e
    return (frame, u * c - w * s, u * s + w * c), f32(obs[:, :5])


# Kernel (h)'s windows: the routes, the route points the ego is near and
# the path widths (``kh_window``), and its round counts
KH_ROUTES = ("curved", "straight", "circuit")
KH_AT = (0, 4000, 11000)
KH_WIDTHS = (600, 64)
KH_ROUNDS = (1, 10)


def kh_window(route: str, at: int, n: int, dev="cpu"):
    """Kernel (h)'s input: the ego-shifted waypoint window (x_wp, y_wp),
    float32 (n,) on ``dev``, of ``closedloop.make_route(route)`` with the
    ego near the route's point ``at``, jittered by a numpy generator of its
    own (seed 5 + at), over 300 m of arc."""
    from ..closedloop import make_route
    from ..frenet import fit_path_spline, waypoint_window
    sp = fit_path_spline(*make_route(route))
    rng = np.random.default_rng(5 + at)
    xe = sp.x_data[at] + rng.normal(0.0, 0.5)
    ye = sp.y_data[at] + rng.normal(0.0, 0.5)
    xw, yw, _ = waypoint_window(sp, xe, ye, 300.0, n)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return f32(xw - xe), f32(yw - ye)


def kh_closedloop(cfg, dev, arc: float = 150.0):
    """``closedloop.local_problem``'s waypoints with the ego ``arc`` metres
    along ``run_episode``'s curved route (``kg_closedloop``'s step), and
    the smoother: (sw, x_wp, y_wp), kernel (h)'s arguments."""
    from ..closedloop import make_route
    from ..frenet import build_smoother, fit_path_spline, waypoint_window
    sp = fit_path_spline(*make_route("curved"))
    x_e, y_e = float(sp.cs_x(arc)), float(sp.cs_y(arc))
    x_wp, y_wp, _ = waypoint_window(sp, x_e, y_e, cfg.frenet.lookahead, cfg.frenet.num_path)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return build_smoother(cfg.frenet.num_path, device=dev), f32(x_wp - x_e), f32(y_wp - y_e)


def kg_state_inputs(gen, cfg, frame, n: int, at=(0.0, 0.0)):
    """The state form's inputs (``ops.frenet_states``'s arguments) for n
    states around the global point ``at`` of ``frame``: standard normals
    z (n, 4) and the state [x, y, 6, 0.5, psi, 0.05] with psi the path's
    heading at its 10th point (or 0.3), on the generator's device."""
    dev = gen.device
    z = torch.randn(n, 4, device=dev, generator=gen)
    fx, fy = frame.Fx_dot[min(10, frame.Fx_dot.shape[0] - 1)], frame.Fy_dot[
        min(10, frame.Fy_dot.shape[0] - 1)]
    psi = float(torch.atan2(fy, fx)) if bool(torch.isfinite(fx) & torch.isfinite(fy)) else 0.3
    init = torch.tensor([at[0], at[1], 6.0, 0.5, psi, 0.05], device=dev)
    return frame, z, init, cfg.frenet.init_mu, cfg.frenet.init_sigma, cfg.cem.num_batch


# the glue around the rollouts: (kind, source, C entry) of kernel (f), K4n
# and kernel (g), and their shapes: (workload, scenarios, MMD kernel),
# (workload, scenarios, mode) and (workload, scenarios)
GLUE_SOURCES = (("kf", "inner_prologue.cu", "mmd_inner_prologue"),
                ("k4n", "rollout.cu", "mmd_noisy_rollout"),
                ("kg", "frenet_points.cu", "mmd_frenet_points"))
GLUE_ENTRIES = {kind: entry for kind, _, entry in GLUE_SOURCES}
# every path shape: fastrt x 1, 4, 8 (E1, E4, E8), Path A x 1, 4 (A, EA4),
# Path D, the record cells N = 5 and 15 (F5, F15); (f) also with D2; K4n
# also Path B's R rollouts under Beta noise x 1, 4 (B, EB4) and Path D's
# other modes
KF_SHAPES = (("fastrt", 1, "laplace"), ("fastrt", 4, "laplace"), ("fastrt", 8, "laplace"),
             ("path_a", 1, "laplace"), ("path_a", 4, "laplace"), ("path_d", 1, "laplace"),
             ("f5", 1, "laplace"), ("f15", 1, "laplace"), ("fastrt", 1, "matern52"))
K4N_SHAPES = (("fastrt", 1, "mmd_opt"), ("fastrt", 4, "mmd_opt"), ("fastrt", 8, "mmd_opt"),
              ("path_a", 1, "mmd_opt"), ("path_a", 4, "mmd_opt"), ("path_a", 1, "cvar"),
              ("path_a", 4, "cvar"), ("path_d", 1, "mmd_opt"), ("path_d", 1, "cvar"),
              ("f5", 1, "mmd_opt"), ("f15", 1, "mmd_opt"))
KG_SHAPES = (("path_d", 1), ("path_d", 4))
# kernel (g)'s other entries: the state and obstacle forms (a build whose
# source lacks one is not run there)
KG_FORMS = ("mmd_frenet_states", "mmd_frenet_obstacles")
# the probe's idx and visits in mmd_frenet_points (the source's text of
# them, their positions), which an earlier entry lacks
KG_PROBE, KG_PROBE_AT = "float* l, int* idx, int* visits", (9, 10)
# the obstacle form's trajectory arguments t, traj and num (the source's
# text of them, their positions), which an earlier entry lacks
KG_TRAJ, KG_TRAJ_AT = "const float* t, float* traj, int num", (10, 11, 12)
# K4 (``rollout.cu``'s other entry, sharing K4n's step): lanes, a state per
# lane?  The exact strategy's 6,400 and on-road 1,600, and the validator's
K4_SHAPES = ((6400, False), (1600, True), (256_000, False))


def run_glue(libs: dict, names: list, gen, log, warm_only=False) -> list:
    """Kernel (f), K4n and kernel (g): every build bit-equal to its plain
    version in every output at its shapes (else it raises), and the builds
    of a kind timed in turns, warm and L2-cold; (f)'s plain D and D2 checked
    for bit-symmetry; K4 of every K4n build bit-equal to the first's (K4's
    bits do not move) and timed in turns; the clock builds' cycles a phase
    (mean and max over the blocks' thread 0) at every shape."""
    from ..frenet import global_to_frenet_obstacle, global_to_frenet_points, initial_states
    from ..ops.frenet_points import (frenet_obstacles, frenet_points, frenet_states,
                                     nearest_pruned)
    from ..ops.inner_prologue import inner_prologue, inner_prologue_plain
    from ..ops.rollout import noisy_rollout, noisy_rollout_plain
    cfgs = _workloads()
    cases = []
    for name, N, kind in KF_SHAPES:
        args = kf_inputs(gen, cfgs[name], N, kind)
        cases.append(("kf", f"{name} x {N} {kind}", args, inner_prologue,
                      inner_prologue_plain, "inner_prologue_kernel"))
    for name, N, mode in K4N_SHAPES:
        args = k4n_inputs(gen, cfgs[name].with_risk_mode(mode), N, name == "path_d")
        cases.append(("k4n", f"{name} x {N} {mode}", args, noisy_rollout,
                      noisy_rollout_plain, "noisy_rollout_kernel"))
    for name, N in KG_SHAPES:
        args = kg_inputs(gen, cfgs[name], N)
        cases.append(("kg", f"{name} x {N}", args, frenet_points, global_to_frenet_points,
                      "frenet_points_kernel"))
    if any(n.startswith("kg_") for n in names):
        (frame, x, y), obs = kg_closedloop(gen, cfgs["path_d"])
        cases.append(("kg", "path_d x 1 on a closed-loop frame", (frame, x, y),
                      frenet_points, global_to_frenet_points, "frenet_points_kernel"))
        cases += [("kg", case, kg_case(case, "cuda"), frenet_points, global_to_frenet_points,
                   "frenet_points_kernel") for case in KG_FULL]
        # the forms, where a build's source has them: the state form at Path
        # D's states in mmd_opt, cvar / saa / mmd_random and det, the obstacle
        # form at the closed loop's obstacles
        for n in (16, 4, 1):
            cases.append(("kg", f"frenet_states x {n} on a closed-loop frame",
                          kg_state_inputs(gen, cfgs["path_d"], frame, n), frenet_states,
                          initial_states, "frenet_states_kernel", "mmd_frenet_states"))
        cases.append(("kg", f"frenet_obstacles x {obs.shape[0]} on a closed-loop frame",
                      (frame, obs), frenet_obstacles,
                      lambda f, o: global_to_frenet_obstacle(f, *o.unbind(1)),
                      "frenet_points_kernel", "mmd_frenet_obstacles"))
    recs = []
    for kind, label, args, wrapper, plain, match, *entry in cases:
        builds = [n for n in names if n.startswith(f"{kind}_") and "_clock" not in n
                  and (not entry or entry[0] in SOURCES.get(n, ""))]
        clocks = [n for n in names if n.startswith(f"{kind}_clock")]
        if not builds:
            continue
        ref = plain(*args)
        calls = {b: (lambda b=b: wrapper(*args, lib=libs[b])) for b in builds}
        if kind == "kf" and "kf_now" in builds and "int cluster" in SOURCES.get("kf_now", ""):
            from ..ops.inner_prologue import MAX_SMEM, smem_bytes
            B, M, T = args[1].shape[0] * args[1].shape[1], args[1].shape[2], args[1].shape[3]
            nvar = args[0].P_prime.shape[1]
            calls.update({f"kf_now@{c}": (lambda c=c: wrapper(*args, lib=libs["kf_now"],
                                                               cluster=c))
                          for c in KF_CLUSTERS if smem_bytes(M, T, nvar, c) <= MAX_SMEM})
        for b, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            if not all(same_bits(g, r) for g, r in zip(got, ref) if r is not None):
                raise RuntimeError(f"{b} is not bit-equal to its plain version at {label}")
        rec = {"kind": kind, "shape": label}
        if kind == "kf":
            rec["plain_symmetric"] = {
                f: same_bits(t, t.transpose(-1, -2))
                for f, t in (("D", ref.D), ("D2", ref.D2)) if t is not None}
            log(f"kf {label}: the plain chain's {rec['plain_symmetric']} bit-symmetric")
        if kind == "kg" and wrapper is frenet_points:
            _, visits = nearest_pruned(args[0], args[1], args[2])
            rec["tiles_visited"] = {"mean": float(visits.double().mean()),
                                    "max": int(visits.max())}
            log(f"kg {label}: tiles visited a point (the twin's, tiles of 32) "
                f"{rec['tiles_visited']}")
        rec["device_ms"] = three_ways(calls, match, warm_only=warm_only)
        log(f"{kind} {label}: {builds} bit-equal to the plain version; device us "
            f"{_fmt_times(rec['device_ms'])}")
        if clocks and not entry:
            T = args[1].shape[-1] if kind == "kf" else args[0].shape[-1] if kind == "k4n" else 1
            rec["clock"] = {}
            for c in clocks:
                rec["clock"][c] = _clock_regions(
                    libs[c], c, lambda c=c: wrapper(*args, lib=libs[c]),
                    entry=GLUE_CLOCK_ENTRY)
                cyc = rec["clock"][c]["cycles"]
                steps = (f"; steps / T {cyc['steps']['mean'] / T:.1f} cycles"
                         if "steps" in cyc else "")
                log(f"{kind} {label} {c}: {rec['clock'][c]['blocks']} blocks, cycles "
                    + ", ".join(f"{r} {v['mean']:.0f} (max {v['max']:.0f})"
                                for r, v in cyc.items()) + steps
                    + f"; SM clock {rec['clock'][c]['sm_clock']}")
        recs.append(rec)
    k4s = [n for n in names if n.startswith("k4n_") and "_clock" not in n]
    for lanes, per_lane in (K4_SHAPES if k4s else ()):
        acc = 1.0 + 0.5 * torch.randn(lanes, 50, device="cuda", generator=gen)
        steer = 0.1 * torch.randn(lanes, 50, device="cuda", generator=gen)
        s0 = torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device="cuda")
        if per_lane:
            s0 = s0 + torch.tensor([0.05, 0.1, 0.5, 0.1, 0.02], device="cuda") * torch.randn(
                lanes, 5, device="cuda", generator=gen)
        outs = {n: (torch.empty_like(acc), torch.empty_like(acc)) for n in k4s}

        def k4(n):
            x, y = outs[n]
            _call(libs[n].mmd_fused_rollout(
                acc.data_ptr(), steer.data_ptr(), s0.data_ptr(), 5 if per_lane else 0,
                x.data_ptr(), y.data_ptr(), lanes, 50, 0.15, 2.5, _stream()), n)
        for n in k4s:
            k4(n)
        torch.cuda.synchronize()
        equal = {n: all(same_bits(a, b) for a, b in zip(outs[n], outs[k4s[0]]))
                 for n in k4s[1:]}
        if not all(equal.values()):
            raise RuntimeError(f"K4's bits moved at {lanes} lanes: {equal}")
        times = three_ways({n: (lambda n=n: k4(n)) for n in k4s}, "rollout_kernel",
                           warm_only=warm_only)
        label = f"{lanes} lanes x 50" + (", a state per lane" if per_lane else "")
        recs.append({"kind": "k4", "shape": label, "bit_equal": equal, "device_ms": times})
        log(f"k4 {label}: {k4s} bit-equal; device us {_fmt_times(times)}")
    return recs


def kh_phases(cycles: dict, rounds: int) -> dict:
    """Kernel (h)'s cycles a phase from a kh_clock launch (``_clock_regions``'
    cycles): the staging's and the whole block's mean over the CTAs, a
    round's phases' mean a round, the tail's phases (``KH_TAILS``) the most
    over the CTAs (CTA 0's scan or gather; the path parameters every
    CTA's, CTA 0's alone in the first design)."""
    out = {"staging": cycles["staging"]["mean"]}
    out.update({f"{p} a round": cycles[p]["mean"] / rounds for p in KH_ROUND_PHASES})
    out.update({p: cycles[p]["max"] for tail in KH_TAILS for p in tail if p in cycles})
    out["whole"] = cycles["block"]["mean"]
    return {k: round(v, 1) for k, v in out.items()}


def run_kh(libs: dict, names: list, log, warm_only=False) -> list:
    """Kernel (h): every build bit-equal to the chain (``frenet.smooth_path``
    then ``path_parameters``) on ``kh_window``'s windows (every route,
    point, width and round count) and on the closed loop's window
    (``kh_closedloop``), where it raises otherwise; the builds but the clock
    builds timed in turns on the closed loop's window, warm and L2-cold;
    and each clock build's cycles a phase there (``kh_phases``)."""
    from ..config import onroad_workload
    from ..frenet import build_smoother, path_parameters, smooth_path
    from ..ops.local_frame import local_frame
    cfg = onroad_workload()
    thr = cfg.frenet.smooth_threshold
    runs = [(f"{r} near {at}, num_path {n}, {k} rounds",
             (build_smoother(n, maxiter=k, device="cuda"), *kh_window(r, at, n, "cuda")))
            for r in KH_ROUTES for at in KH_AT for n in KH_WIDTHS for k in KH_ROUNDS]
    closed = ("the closed loop's window", kh_closedloop(cfg, "cuda"))
    for label, (sw, x, y) in runs + [closed]:
        ref = path_parameters(*smooth_path(sw, x, y, thr))
        for b in names:
            got = local_frame(sw, x, y, thr, lib=libs[b])
            torch.cuda.synchronize()
            if not all(same_bits(g, r) for g, r in zip(got, ref)):
                raise RuntimeError(f"{b} is not bit-equal to the chain at {label}")
    log(f"kh: {names} bit-equal to the chain at {len(runs) + 1} windows")
    sw, x, y = closed[1]
    calls = {b: (lambda b=b: local_frame(sw, x, y, thr, lib=libs[b]))
             for b in names if "_clock" not in b}
    times = three_ways(calls, "local_frame_kernel", warm_only=warm_only)
    rec = {"kind": "kh", "shape": closed[0], "device_ms": times, "clock": {}}
    for c in (b for b in names if "_clock" in b):
        got = _clock_regions(libs[c], c, lambda c=c: local_frame(sw, x, y, thr, lib=libs[c]),
                             entry=GLUE_CLOCK_ENTRY)
        rec["clock"][c] = kh_phases(got["cycles"], sw.maxiter)
    log(f"kh {closed[0]}: device us {_fmt_times(times)}; clock64 cycles {rec['clock']}; "
        f"SM clock {sm_clock_mhz()}")
    return [rec]


# kernel (d)'s forced launch choices (``ops.outer_project``'s keywords)
KD_CHOICES = {"rows1": {"rows_per_cta": 1}, "rows2": {"rows_per_cta": 2},
              "runtime": {"runtime_shape": True}}
FLUSH_FLOATS = 16 * 2 ** 20   # 64 MB, written between launches: past the 50 MB L2


def _workloads():
    from ..config import (dynamic_workload, fastrt_workload, onroad_workload,
                          static_workload)
    obs = lambda cfg: cfg.replace(projection=dataclasses.replace(
        cfg.projection, with_obstacle_terms=True))
    # the JAX record's static cells (chip_smoke.record_config)
    record = lambda N: static_workload(num_reduced=N, num_obs=6, num_prime=50,
                                       noise="beta", noise_level=0.3, mode="mmd_opt")
    return {"fastrt": fastrt_workload(), "path_a": dynamic_workload(noise_level=0.2),
            "path_d": onroad_workload(), "fastrt_obs": obs(fastrt_workload()),
            "f5": record(5), "f15": record(15),
            "path_d_det": obs(onroad_workload(mode="det")),
            **{f"path_b_{m}": dynamic_workload(noise_level=0.2, mode=m)
               for m in ("cvar", "saa", "mmd_random")},
            **{f"path_d_{m}": onroad_workload(mode=m) for m in ("cvar", "saa", "mmd_random")}}


def _with_form(names: list, cfg, kind: str) -> list:
    """The builds of ``names`` whose source has the form of kernel (d) or
    (e) that ``cfg`` takes (an earlier build may lack it)."""
    if kind == "kd" and cfg.projection.with_obstacle_terms:
        return [n for n in names if KD_OBS_MARKER in SOURCES.get(n, "")]
    if kind == "ke" and cfg.risk.mode != "mmd_opt":
        return [n for n in names if KE_FORMS_MARKER in SOURCES.get(n, "")]
    return names


def evictor(lib, gen, name: str, N: int):
    """A launch of kernel (c) (``lib``'s) at the inner CEM's shape on the
    path of a KD / KE shape, as the solve's graph runs it before (d); None
    without ``lib``."""
    shapes = {"fastrt": (64 * N, 64, 10, 12), "path_a": (100, 100, 10, 20),
              "path_d": (100, 100, 4, 20)}
    if lib is None or name not in shapes:    # a path without kernel (c)
        return None
    C, S, k, maxiter = shapes[name]
    inp, n_el, rho, reg = kc_inputs(gen, C, S, k, maxiter)
    outs = _kc(lib, inp, k, n_el, rho, reg, "laplace")
    return lambda: _kc(lib, inp, k, n_el, rho, reg, "laplace", outs)


def three_ways(calls: dict, match: str, evict=None, cold=None, warm_only=False) -> dict:
    """Device ms of each window of each call, in turns: warm (back to back),
    L2-cold (a 64 MB buffer written before each launch) and evicted
    (``evict`` before each launch), for the names in ``cold`` (default
    all); with ``warm_only`` only the first."""
    out = {"warm": in_turns(calls, match)}
    if warm_only:
        return out
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    some = {n: f for n, f in calls.items() if cold is None or n in cold}
    out["l2_cold"] = in_turns({n: (lambda f=f: (flush.fill_(1.0), f()))
                               for n, f in some.items()}, match)
    if evict is not None:
        out["evicted"] = in_turns({n: (lambda f=f: (evict(), f())) for n, f in some.items()},
                                  match)
    return out


def _equal_counts(got, ref) -> list:
    """Bit-equal entries (NaN to NaN) of each output, as "equal/total"."""
    return [f"{int(((g == r) | (g.isnan() & r.isnan())).sum())}/{r.numel()}"
            for g, r in zip(got, ref)]


def _clock_regions(lib, name: str, call, per: int = 1,
                   entry: str = "mmd_outer_project_clock") -> dict:
    """The cycles thread 0 of each block spends in each region of a clock
    build (mean and max over the blocks that stamped), divided by ``per``."""
    stamps = torch.zeros(4096 * KC_CLOCK_SLOTS, dtype=torch.int64, device="cuda")
    entry = getattr(lib, entry)
    _call(entry(stamps.data_ptr(), 1), name)
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    _call(entry(stamps.data_ptr(), 0), name)
    torch.cuda.synchronize()
    st = stamps.view(4096, KC_CLOCK_SLOTS)
    st = st[st[:, -1] > 0].double()
    regions = CLOCK_REGIONS[name]
    out = {r: {"mean": float(st[:, i].mean() / per), "max": float(st[:, i].max() / per)}
           for i, r in enumerate(regions)}
    out["block"] = {"mean": float(st[:, -1].mean()), "max": float(st[:, -1].max())}
    return {"blocks": len(st), "cycles": out, "sm_clock": sm_clock_mhz()}


def _fmt_times(times: dict) -> str:
    return "; ".join(f"{way}: " + ", ".join(
        f"{n} {[round(1e3 * t, 2) for t in ts]}" for n, ts in by.items())
        for way, by in times.items())


def run_kd(libs: dict, names: list, gen, log, evict_lib=None, warm_only=False) -> list:
    """Kernel (d): every build and ``kd_now``'s forced launch choices
    against the plain version (bit-equal entries of each output) and
    bit-equal to ``kd_before`` in every output (else it raises), at the
    paths' shapes (``KD_SHAPES``); their device times per launch in turns,
    warm, L2-cold and evicted (kernel (c) at the path's shape before each
    launch); and each clock build's cycles a phase of its block's row."""
    import inspect
    from ..ops.outer_project import OuterProjection, outer_project, outer_project_plain
    choices = (KD_CHOICES if "rows_per_cta" in inspect.signature(outer_project).parameters
               else {})
    cfgs = _workloads()
    recs = []
    for name, N, frenet in KD_SHAPES:
        have = _with_form(names, cfgs[name], "kd")
        exact = [n for n in have if "_clock" not in n]
        args, kw = kd_inputs(gen, cfgs[name], N, frenet)
        ref = outer_project_plain(*args, **kw)
        calls = {}
        for b in exact:
            calls[b] = (lambda b=b: outer_project(*args, **kw, lib=libs[b]))
            if b == "kd_now":
                for c, ch in choices.items():
                    calls[f"kd_now {c}"] = (lambda ch=ch: outer_project(
                        *args, **kw, lib=libs["kd_now"], **ch))
        outs = {label: fn() for label, fn in calls.items()}
        torch.cuda.synchronize()
        plain = {label: dict(zip(OuterProjection._fields, _equal_counts(o, ref)))
                 for label, o in outs.items()}
        before = None
        if "kd_before" in outs:
            before = {label: all(same_bits(g, r) for g, r in zip(o, outs["kd_before"]))
                      for label, o in outs.items()}
            if not all(before.values()):
                raise RuntimeError(f"kernel (d) builds not bit-equal to kd_before at "
                                   f"{name} x {N}: {before}")
        times = three_ways(calls, "outer_project", evictor(evict_lib, gen, name, N),
                           warm_only=warm_only)
        clock = {b: _clock_regions(libs[b], b, lambda b=b: outer_project(*args, **kw,
                                                                           lib=libs[b]))
                 for b in have if "_clock" in b}
        recs.append({"shape": [name, N], "bit_equal_to_plain": plain,
                     "bit_equal_to_before": before, "device_ms": times, "clock": clock})
        log(f"kernel (d) {name} x {N}: bit-equal to kd_before {before}; bit-equal entries "
            f"to the plain version {plain}; device us {_fmt_times(times)}")
        for b, c in clock.items():
            log(f"  {b}: clock64 cycles of thread 0 a block ({c['blocks']} blocks; mean / "
                "max): " + ", ".join(f"{r} {v['mean']:.0f} / {v['max']:.0f}"
                                     for r, v in c["cycles"].items())
                + f"; SM clock, max MHz: {c['sm_clock']}")
    return recs


def run_ke(libs: dict, names: list, gen, log, evict_lib=None, warm_only=False) -> list:
    """Kernel (e) of each build at each forced cluster size against its
    plain version at the paths' shapes (``KE_SHAPES``): the kept and elite
    indices and the pick equal, the moments and parameters' largest gap,
    bit-equal entries; every output (res and res_2 too) bit-equal to
    ``ke_before`` at the same size (else it raises); each build and size's
    warm device time in turns, the picked size's L2-cold and evicted times;
    and the clock64 cycles of rank 0's thread 0 between its stamps."""
    from ..ops.outer_tail import TailResult, outer_tail, outer_tail_plain
    cfgs = _workloads()
    fields = TailResult._fields + ("res", "res_2")
    recs = []
    all_names = names
    for name, N, frenet in KE_SHAPES:
        names = _with_form(all_names, cfgs[name], "ke")
        args = ke_inputs(gen, cfgs[name], N, frenet)
        r1, r2 = args[15].clone(), args[16].clone()
        ref = tuple(outer_tail_plain(*args[:15], r1, r2, args[17])) + (r1, r2)
        outs = {}
        for b in names:
            for cs in (0, 1, 2, 4, 8):
                r1, r2 = args[15].clone(), args[16].clone()
                got = outer_tail(*args[:15], r1, r2, args[17], cluster=cs, lib=libs[b])
                outs[(b, cs)] = tuple(got) + (r1, r2)
        torch.cuda.synchronize()
        rec = {"shape": [name, N], "builds": {}}
        for (b, cs), o in outs.items():
            same = all(torch.equal(g, r) for g, r in zip(o, ref) if g.dtype == torch.int64)
            gap = max(float((g - r).abs().nan_to_num(0.0).max()) for g, r in zip(o[:3], ref[:3]))
            eq_before = (all(same_bits(g, r) for g, r in zip(o, outs[("ke_before", cs)]))
                         if ("ke_before", cs) in outs else None)
            if eq_before is False:
                raise RuntimeError(f"kernel (e) {b} at cluster {cs} not bit-equal to "
                                   f"ke_before at {name} x {N}")
            rec["builds"][f"{b} cluster{cs}"] = {
                "indices_equal": same, "moments_gap": gap, "bit_equal_to_before": eq_before,
                "bit_equal_to_plain": dict(zip(fields, _equal_counts(o, ref)))}
        calls = {f"{b} cluster{cs}": (lambda b=b, cs=cs: outer_tail(*args, cluster=cs,
                                                                    lib=libs[b]))
                 for b in names for cs in (0, 1, 2, 4, 8)}
        rec["device_ms"] = three_ways(calls, "outer_tail", evictor(evict_lib, gen, name, N),
                                      cold=[f"{b} cluster0" for b in names],
                                      warm_only=warm_only)
        auto = libs[names[0]].mmd_outer_tail_cluster(N)
        rec["auto_cluster"] = auto
        rec["kept_every_cta"] = {}
        for b in [m for m in names if "kept_cta" in SOURCES.get(m, "")]:
            for cs in (1, 2, 4, 8):
                n_cost = outs[(b, cs)][6].shape[1]
                per_cta = torch.full((N * cs, n_cost), -1, dtype=torch.int64, device="cuda")
                got = outer_tail(*args, cluster=cs, lib=libs[b], kept_cta=per_cta)
                torch.cuda.synchronize()
                same = torch.equal(per_cta.reshape(N, cs, n_cost),
                                   got.kept[:, None, :].expand(N, cs, n_cost))
                rec["kept_every_cta"][f"{b} cluster{cs}"] = same
                if not same:
                    raise RuntimeError(f"kernel (e) {b}: the CTAs of a cluster of {cs} keep "
                                       f"other candidates at {name} x {N}")
        rec["clock_cycles"] = {}
        for b in names:
            clock = torch.zeros(N * auto * 8, dtype=torch.int64, device="cuda")
            outer_tail(*args, cluster=auto, lib=libs[b], clock=clock)
            torch.cuda.synchronize()
            st = clock.reshape(N, auto, 8)[:, 0].double()
            rec["clock_cycles"][b] = (st[:, 1:7] - st[:, 0:6]).mean(dim=0).tolist()
        recs.append(rec)
        log(f"kernel (e) {name} x {N}: " + "; ".join(
            f"{k} indices equal {v['indices_equal']}, gap {v['moments_gap']:.2e}, bit-equal "
            f"to ke_before {v['bit_equal_to_before']}" for k, v in rec["builds"].items())
            + f"; kept equal on every CTA {rec['kept_every_cta']}"
            + f"; device us {_fmt_times(rec['device_ms'])}; auto {auto}; clock cycles a "
            "phase " + ", ".join(f"{b} {[round(c) for c in v]}"
                                 for b, v in rec["clock_cycles"].items()))
    return recs


def _k3(lib, samples, D, k, outs):
    C, S, Mp1 = samples.shape
    row_sum, K_red, idx = outs
    _call(lib.mmd_topk_kernel_matrices(samples.data_ptr(), S * Mp1, D.data_ptr(),
                                       row_sum.data_ptr(), K_red.data_ptr(),
                                       idx.data_ptr(), C, S, Mp1 - 1, k, _stream()),
          "mmd_topk_kernel_matrices")


def _k1(lib, x, k, absolute, m, out):
    w = x.shape[-1]
    _call(lib.mmd_topk_indices(x.data_ptr(), out.data_ptr(), x.numel() // w, w, m, k,
                               int(absolute), _stream()), "mmd_topk_indices")


def _k2(lib, C, r, b, mu):
    n = C.shape[-1]
    _call(lib.mmd_eq_qp_solve(C.data_ptr(), r.data_ptr(), b.data_ptr(), mu.data_ptr(),
                              r.numel() // n, n, _stream()), "mmd_eq_qp_solve")


def beta_inputs(gen, K, B, P, mixed=False):
    """Keys (K, 2) and parameters (K, B, P): as a solve sets them (2 and 5
    times a 1e-8-floored |u|, u = 0 at the first step, as chip_smoke.py
    checks kernel (b)), or with ``mixed`` each 10^U(-8, 2), so that the
    candidates of one element take other round counts, alpha < 1 among
    them."""
    dev = gen.device
    keys = torch.randint(0, 2 ** 32, (K, 2), generator=gen, device=dev,
                         dtype=torch.int64)
    if mixed:
        a, b = (10.0 ** (10.0 * torch.rand((K, B, P), generator=gen, device=dev) - 8.0)
                for _ in range(2))
        return keys, a, b
    u = 0.6 * torch.rand((K, B, P), generator=gen, device=dev)
    u[..., 0] = 0.0
    return keys, 2.0 * (u + 1e-8), 5.0 * (u + 1e-8)


def _beta(lib, keys, a, b, n, out):
    K, B, P = a.shape
    _call(lib.mmd_prng_beta(keys.data_ptr(), a.data_ptr(), b.data_ptr(), K, B, n, P,
                            out.data_ptr(), _stream()), "mmd_prng_beta")


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN equal to NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def in_turns(fns: dict, match: str, windows: int = 3) -> dict:
    """name -> device ms of each window, the names timed in turns."""
    times = {name: [] for name in fns}
    for w in range(windows):
        for name in (list(fns) if w % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name], match))
    return times


def run_k5(libs: dict, gen, log) -> dict:
    """K5 (``topk.cu``'s one-hot entry) of ``k1_now`` against ``k1_before``."""
    x = torch.randn(64, 57, 101, device="cuda", generator=gen)
    idx = torch.empty(64, 57, 10, dtype=torch.int32, device="cuda")
    onehot = torch.empty(64, 57, 10, 100, device="cuda")

    def k5(name):
        _call(libs[name].mmd_topk_onehot(x.data_ptr(), idx.data_ptr(), onehot.data_ptr(),
                                         64 * 57, 101, 100, 10, 1, _stream()),
              "mmd_topk_onehot")

    outs = []
    for name in ("k1_now", "k1_before"):
        k5(name)
        torch.cuda.synchronize()
        outs.append((idx.clone(), onehot.clone()))
    times = in_turns({n: (lambda n=n: k5(n)) for n in ("k1_now", "k1_before")}, "topk")
    rec = {"shape": [64, 57, 101], "k": 10, "device_ms": times,
           "equal_to_before": all(torch.equal(a, c) for a, c in zip(*outs))}
    log(f"K5 (64, 57, 101) k=10: now equal to before {rec['equal_to_before']}; "
        "device us " + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}"
                                 for n, ts in times.items()))
    return rec


def run_prng(libs: dict, names: list, gen, log) -> list:
    """Kernel (b): each build against the twin and ``prng_now`` against
    ``prng_before``, then their times in turns beside the library call."""
    recs = []
    for (K, B, n, P), mixed in [(s, False) for s in PRNG_SHAPES] + [
            (s, True) for s in PRNG_MIXED]:
        keys, a, b = beta_inputs(gen, K, B, P, mixed)
        ref = prng.beta_draws(keys, a, b, n)
        got = {}
        for name in [m for m in names if "_no_" not in m]:
            o = torch.full((K, B, n), -1.0, device="cuda")
            _beta(libs[name], keys, a, b, n, o)
            torch.cuda.synchronize()
            gap = (o - ref).abs()
            if not bool(((gap <= 1e-5 * ref.abs() + 1e-6) | (o.isnan() & ref.isnan())).all()):
                raise RuntimeError(f"{name} outside rtol 1e-5 + atol 1e-6 of the twin at "
                                   f"{(K, B, n, P)}, mixed {mixed}")
            got[name] = (o, float(gap.nan_to_num(0.0).max()))
        equal = (all(same_bits(o, got["prng_before"][0]) for o, _ in got.values())
                 if "prng_before" in got else None)
        if equal is False:
            raise RuntimeError(f"a build is not bit-equal to prng_before at {(K, B, n, P)}")
        o = torch.empty((K, B, n), device="cuda")
        times = in_turns({m: (lambda m=m: _beta(libs[m], keys, a, b, n, o)) for m in names},
                         "beta")
        full = torch.stack((a, b))[:, :, :, None, :].expand(2, K, B, n // P, P).contiguous()
        lib_ms = device_ms(lambda: torch._standard_gamma(full), "")
        clock = None
        if "prng_clock" in libs:
            lib, stamps = libs["prng_clock"], torch.zeros(4096 * 8, dtype=torch.int64,
                                                          device="cuda")
            _call(lib.mmd_prng_clock(stamps.data_ptr(), 1), "mmd_prng_clock")
            _beta(lib, keys, a, b, n, o)
            torch.cuda.synchronize()
            _call(lib.mmd_prng_clock(stamps.data_ptr(), 0), "mmd_prng_clock")
            torch.cuda.synchronize()
            st = stamps.view(4096, 8)
            st = st[st[:, 4] > 0]
            clock = {name: {"mean": float(st[:, i].double().mean()),
                            "max": int(st[:, i].max())}
                     for i, (_, name) in enumerate(CLOCK_STAMPS)} if len(st) else None
            log(f"  clock64 cycles from a block's start (mean / max over blocks): "
                + ", ".join(f"{k} {v['mean']:.0f} / {v['max']}" for k, v in clock.items())
                if clock else "  clock64: no block stamped (B = 1 runs beta_kernel)")
        recs.append({"shape": [K, B, n, P], "mixed": mixed, "bit_equal_to_before": equal,
                     "clock_cycles": clock,
                     "max_gap_to_twin": {m: g for m, (_, g) in got.items()},
                     "device_ms": times, "standard_gamma_ms": lib_ms})
        log(f"kernel (b) {K} keys x {B} x {n}, P = {P}{', mixed alpha' if mixed else ''}: "
            f"every build bit-equal to before {equal}; largest gap to the twin "
            f"{max(g for _, g in got.values()):.3e}; device us "
            + ", ".join(f"{m} {[round(1e3 * t, 3) for t in ts]}" for m, ts in times.items())
            + f"; torch._standard_gamma {1e3 * lib_ms:.3f}")
    return recs


def _kc(lib, inp, k, n_el, rho, reg, kind, outs=None):
    """Kernel (c)'s "xla" form with elite-carry of one build on ``inp``
    (``kc_inputs``), as ``ops.inner_cem`` calls it; returns (beta_w,
    sigma_w, idx_best, res)."""
    import numpy as np
    from ..ops.inner_cem import G_BLOCK_BYTES, KINDS
    D, D2, s0, A, Z, floor = inp
    C, M, S, maxiter = D.shape[0], D.shape[-1], s0.shape[0], A.shape[0]
    kind_i = KINDS.index(kind)
    if outs is None:
        outs = (torch.full((C, k), float("nan"), device="cuda"),
                torch.full((C,), float("nan"), device="cuda"),
                torch.full((C, k), -1, dtype=torch.int64, device="cuda"),
                torch.full((C, maxiter), float("nan"), device="cuda"))
    beta_w, sigma_w, idx_best, res = outs
    forms = getattr(lib, "kc_forms", False)
    per = lib.mmd_inner_cem_scratch(S, M, k, n_el, kind_i, *((0, 0) if forms else ()))
    scratch = torch.empty(max(1, C * per), device="cuda")
    _call(lib.mmd_inner_cem(
        D.data_ptr(), None if D2 is None else D2.data_ptr(), s0.data_ptr(), A.data_ptr(),
        Z.data_ptr(), floor.data_ptr(), beta_w.data_ptr(), sigma_w.data_ptr(),
        idx_best.data_ptr(), res.data_ptr(), scratch.data_ptr(), C, S, M, k, n_el, maxiter,
        kind_i, rho, reg, float(np.float32(-rho * (1.0 / M))),
        float(np.float32(1.0) / np.float32(rho)),
        *((0, 0, G_BLOCK_BYTES // 4) if forms else ()), _stream()), "mmd_inner_cem")
    return outs


def sm_clock_mhz() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip()


def run_kc(libs: dict, names: list, gen, log, shapes=KC_SHAPES) -> list:
    """Kernel (c): every build but the clock ones bit-equal to ``kc_before``
    (NaN to NaN) in all four outputs, for every candidate, at ``shapes``;
    then their device times in turns and, for each clock build, the cycles
    a block's thread 0 spends in each phase an iteration (mean and max over
    blocks)."""
    recs = []
    exact = [n for n in names if not n.startswith("kc_clock")]
    for C, S, k, maxiter, kind in shapes:
        inp, n_el, rho, reg = kc_inputs(gen, C, S, k, maxiter, kind)
        got = {}
        sizes = {}
        for name in exact:
            got[name] = _kc(libs[name], inp, k, n_el, rho, reg, kind)
            torch.cuda.synchronize()
            if hasattr(libs[name], "mmd_inner_cem_last_cluster"):
                sizes[name] = libs[name].mmd_inner_cem_last_cluster()
        ref = got.get("kc_before")
        equal = None
        if ref is not None:
            equal = {n: all(same_bits(a, b) for a, b in zip(o, ref)) for n, o in got.items()}
            if not all(equal.values()):
                raise RuntimeError(f"kernel (c) builds not bit-equal to kc_before at "
                                   f"{(C, S, k, maxiter, kind)}: {equal}")
        outs = tuple(torch.empty_like(t) for t in next(iter(got.values())))
        times = in_turns({n: (lambda n=n: _kc(libs[n], inp, k, n_el, rho, reg, kind, outs))
                          for n in exact}, "inner_cem_kernel")
        clock = {}
        for name in [n for n in names if n.startswith("kc_clock")]:
            lib = libs[name]
            stamps = torch.zeros(4096 * KC_CLOCK_SLOTS, dtype=torch.int64, device="cuda")
            _call(lib.mmd_inner_cem_clock(stamps.data_ptr(), 1), "mmd_inner_cem_clock")
            torch.cuda.synchronize()
            _kc(lib, inp, k, n_el, rho, reg, kind, outs)
            torch.cuda.synchronize()
            _call(lib.mmd_inner_cem_clock(stamps.data_ptr(), 0), "mmd_inner_cem_clock")
            torch.cuda.synchronize()
            st = stamps.view(4096, KC_CLOCK_SLOTS)
            st = st[st[:, -1] > 0].double()
            regions = CLOCK_REGIONS[name]
            once = ("staging", "tail")
            per_it = {r: {"mean": float(st[:, i].mean() / (1 if r in once else maxiter)),
                          "max": float(st[:, i].max() / (1 if r in once else maxiter))}
                      for i, r in enumerate(regions)}
            per_it["block"] = {"mean": float(st[:, -1].mean()), "max": float(st[:, -1].max())}
            clock[name] = {"blocks": len(st), "cycles": per_it, "sm_clock": sm_clock_mhz()}
            log(f"  {name}: clock64 cycles of thread 0 a block ({len(st)} blocks; phases "
                f"an iteration, staging, tail and block a launch; mean / max): "
                + ", ".join(f"{r} {v['mean']:.0f} / {v['max']:.0f}" for r, v in per_it.items())
                + f"; SM clock, max MHz: {clock[name]['sm_clock']}")
        recs.append({"shape": [C, S, k * k, k, maxiter, kind], "bit_equal_to_before": equal,
                     "cluster_size": sizes,
                     "device_ms": times, "clock": clock})
        log(f"kernel (c) C={C}, S={S}, M={k * k}, k={k}, {maxiter} it., {kind}: bit-equal "
            f"to kc_before {equal}; cluster sizes {sizes}; device us "
            + ", ".join(f"{n} {[round(1e3 * t, 1) for t in ts]}" for n, ts in times.items()))
    return recs


def graph_ms(fn, reps: int = 5) -> float:
    """Milliseconds a replay of ``fn()`` captured as one CUDA graph (as a
    solve runs a chain of many launches), CUDA events around ``reps``
    replays after one more."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                         # the warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def inner_chain(cfg, cx, cy, inp, k, n_el, rho, reg, selection, carry):
    """The plain chain of the inner CEM under (selection, elite-carry) on
    ``inp``: ``ops.inner_cem.inner_cem_plain`` with the form arguments
    where the package has them, else (an earlier checkout, whose
    ``select_reduced_set_batched`` ran the chains itself) the chain inside
    ``select_reduced_set_batched`` (with the winner's indices read off its
    last gather).  Returns (beta_w, sigma_w, idx_best, res)."""
    import inspect
    from ..ops.inner_cem import inner_cem_plain
    from .. import reduced_set as rs
    kind = cfg.risk.kernel
    if "selection" in inspect.signature(inner_cem_plain).parameters:
        return inner_cem_plain(*inp, k, n_el, rho, reg, kind, selection=selection,
                               carry=carry, coeffs=(cx, cy))
    D, D2, s0, A, Z, floor = inp
    marker = torch.zeros(cx.shape[0], cx.shape[1], 1, device=cx.device)
    got = {}
    take = rs.take_rows

    def last_gather(t, idx):
        if t is marker:
            got["idx"] = idx
            return t
        return take(t, idx)

    old = os.environ.get("MPC_MMD_ELITE_CARRY")
    os.environ["MPC_MMD_ELITE_CARRY"] = "1" if carry else "0"
    rs.take_rows = last_gather
    try:
        red = rs.select_reduced_set_batched(cfg, cx, cy, marker, marker, None,
                                            selection=selection, distances=(D, D2),
                                            fixed=rs.InnerFixed(s0, A, Z, floor))
    finally:
        rs.take_rows = take
        if old is None:
            os.environ.pop("MPC_MMD_ELITE_CARRY")
        else:
            os.environ["MPC_MMD_ELITE_CARRY"] = old
    return red.beta, red.sigma, got["idx"], red.res


def run_forms(gen, log, shapes=KC_FORM_SHAPES) -> list:
    """Kernel (c)'s forms against their chains on the card, from the
    package's library: at each path shape and (selection, elite-carry)
    pair the chain (``inner_chain``), the "xla" form with elite-carry
    (``ops.inner_cem``) and, where the package has it, the pair's own
    form, on the same inputs (``kc_inputs``: a NaN lane and tied |beta|,
    and an infinite lane for "fused").  Logs how many candidates of the
    chain are bit-equal (NaN to NaN) to the "xla" form and to the pair's
    form in each output (beta_w, sigma_w, idx_best, res), raises where the
    pair's form is not bit-equal to its chain (after every shape ran), and
    times the chain (a replay of it captured as one CUDA graph, as a solve
    runs it) and the forms' kernels (device ms, in turns), on inputs
    without the edge rows (``kc_inputs(edges=False)``)."""
    import inspect
    from .. import ops
    forms = "selection" in inspect.signature(ops.inner_cem).parameters
    recs, apart = [], []
    for path, C, S, k, maxiter, pairs in shapes:
        for selection, carry in pairs:
            inp, n_el, rho, reg, cfg, cx, cy = kc_inputs(
                gen, C, S, k, maxiter, inf_lane=selection == "fused", full=True)
            args = (*inp, k, n_el, rho, reg, "laplace")
            chain = inner_chain(cfg, cx, cy, inp, k, n_el, rho, reg, selection, carry)
            xla = ops.inner_cem(*args)
            kw = dict(selection=selection, carry=carry, coeffs=(cx, cy))
            own = ops.inner_cem(*args, **kw) if forms else None
            torch.cuda.synchronize()
            names = ("beta_w", "sigma_w", "idx_best", "res")

            def equal(got):
                return {n: int(((g == r) | (g.isnan() & r.isnan())).reshape(C, -1)
                               .all(dim=1).sum()) for n, g, r in zip(names, got, chain)}

            rec = {"path": path, "shape": [C, S, k * k, k, maxiter], "selection": selection,
                   "carry": carry, "chain_equal_to_xla": equal(xla),
                   "form_equal_to_chain": equal(own) if own is not None else None}
            # timed on inputs without the edge rows
            inp, n_el, rho, reg, cfg, cx, cy = kc_inputs(gen, C, S, k, maxiter, full=True,
                                                         edges=False)
            args = (*inp, k, n_el, rho, reg, "laplace")
            kw = dict(selection=selection, carry=carry, coeffs=(cx, cy))
            rec["chain_graph_ms"] = graph_ms(lambda: inner_chain(
                cfg, cx, cy, inp, k, n_el, rho, reg, selection, carry))
            timed = {"xla": lambda: ops.inner_cem(*args)}
            if own is not None:
                timed["form"] = lambda: ops.inner_cem(*args, **kw)
            rec["device_ms"] = in_turns(timed, "inner_cem_kernel")
            recs.append(rec)
            log(f"forms {path} C={C}, S={S}, M={k * k}, k={k}, {maxiter} it., "
                f"({selection!r}, carry={carry}): chain bit-equal to the 'xla' form in "
                f"{rec['chain_equal_to_xla']} of {C} candidates, to its own form in "
                f"{rec['form_equal_to_chain']}; chain {rec['chain_graph_ms']:.3f} ms a "
                f"graph replay; kernel device us "
                + ", ".join(f"{n} {[round(1e3 * t, 1) for t in ts]}"
                            for n, ts in rec["device_ms"].items()))
            if own is not None and rec["form_equal_to_chain"] != {n: C for n in names}:
                apart.append((path, selection, carry, rec["form_equal_to_chain"], C))
    if apart:
        raise RuntimeError(f"kernel (c)'s forms not bit-equal to their chains "
                           f"(path, selection, carry, candidates equal, of): {apart}")
    return recs


def run(before: Path, out: Path, diagnose: bool = False, kernels=None,
        warm_only: bool = False) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"card: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = builds(before, diagnose)
    if kernels:
        unknown = (set(kernels) - {v[0] for v in sources.values()} - set(sources)
                   - {"forms"})
        if unknown:
            raise SystemExit(f"kernel_ab: no kind or build named {sorted(unknown)}")
        sources = {n: v for n, v in sources.items() if v[0] in kernels or n in kernels
                   or (v[0] == "step" and "k4n" in kernels)}
    t0 = time.perf_counter()
    # the package's library (kernel (c) between the outer kernels' launches;
    # kernel (c)'s forms, and its build beside DIR's) compiles beside the builds
    package = threading.Thread(target=_build.build, daemon=True)
    kinds = {kind for kind, _ in sources.values()}
    # (K4n's plain version runs the package's K4)
    if ((not warm_only and kinds & {"kd", "ke"}) or kinds & {"kc", "k4n"}
            or "forms" in (kernels or ())):
        package.start()
    libs = build_all(sources, log, before)
    log(f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        sass = OUT_DIR / f"{name}.sass"
        if sass.exists() and out.resolve() != OUT_DIR.resolve():
            (out / sass.name).write_text(sass.read_text())
    k1s = [n for n, (kind, _) in sources.items() if kind == "k1"]
    k2s = [n for n, (kind, _) in sources.items() if kind == "k2"]
    k3s = [n for n, (kind, _) in sources.items() if kind == "k3"]
    prngs = [n for n, (kind, _) in sources.items() if kind == "prng"]
    exact_k1 = [n for n in k1s if n != "k1_no_rounds"]
    exact_k2 = [n for n in k2s if n not in ("k2_no_copies", "k2_no_math")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    rec = {"card": smi.stdout.strip(), "builds": sorted(libs),
           "launch_floor_ms": device_ms(lambda: one.fill_(1.0), "")}
    log(f"launch floor (fill_ of one float): {rec['launch_floor_ms']:.6f} ms")
    if "micro" in libs:
        cyc = torch.zeros(3, dtype=torch.int64, device="cuda")
        _call(libs["micro"].micro(cyc.data_ptr(), 7, _stream()), "micro")
        torch.cuda.synchronize()
        rec["cycles_per_step"] = {"redux.sync max + add": cyc[0].item() / 256,
                                  "shfl.sync xor + add": cyc[1].item() / 256}
        log(f"latency per dependent step, cycles: {rec['cycles_per_step']}")

    rec["k1"] = []
    for shape, k, absolute, m in (K1_SHAPES if k1s else ()):
        x = k1_inputs(gen, shape, k, absolute)
        ref = topk_indices_plain(x, k, absolute, m if m < shape[-1] else None)
        idx = torch.empty(shape[:-1] + (k,), dtype=torch.int32, device="cuda")
        # an earlier build, and the 4-slot variant, rank at most 128 lanes
        k1s_here = [n for n in k1s if n not in ("k1_before", "k1_slots4") or m <= 128]
        for name in [n for n in exact_k1 if n in k1s_here]:
            idx.fill_(-1)
            _k1(libs[name], x, k, absolute, m, idx)
            torch.cuda.synchronize()
            if not torch.equal(idx, ref):
                raise RuntimeError(f"{name} differs from the twin at {shape}, k={k}")
        ranked = (x[..., :m].abs() if absolute else x).contiguous()
        times = in_turns({n: (lambda n=n: _k1(libs[n], x, k, absolute, m, idx))
                          for n in k1s_here}, "topk")
        lib_ms = device_ms(lambda: torch.topk(ranked, k, dim=-1), "")
        rec["k1"].append({"shape": list(shape), "k": k, "absolute": absolute, "m": m,
                          "device_ms": times, "torch_topk_ms": lib_ms})
        log(f"K1 {shape} k={k}: equal to the twin in {len(exact_k1)} builds; device us "
            + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}" for n, ts in times.items())
            + f"; torch.topk {1e3 * lib_ms:.3f}")

    rec["k2"] = []
    for batch, n in (K2_SIZES if k2s else ()):
        C, r = k2_inputs(gen, batch, n)
        b64, mu64 = qp_plain(C.double(), r.double())
        # the earlier build took n = 4 and 10 only
        k2s_here = [m for m in k2s if m != "k2_before" or n in (4, 10)]
        got = {}
        for name in [m for m in exact_k2 if m in k2s_here]:
            b = torch.full_like(r, float("nan"))
            mu = torch.full((batch,), float("nan"), device="cuda")
            _k2(libs[name], C, r, b, mu)
            torch.cuda.synchronize()
            for t, t64 in ((b, b64), (mu, mu64)):
                if not bool(((t.double() - t64).abs() <= 1e-4 * t64.abs() + 1e-5).all()):
                    raise RuntimeError(f"{name} outside rtol 1e-4 + atol 1e-5 at {batch}, "
                                       f"n={n}")
            got[name] = (b, mu)
        equal = (all(torch.equal(a, c) for a, c in zip(got["k2_now"], got["k2_before"]))
                 if "k2_before" in got else None)
        b, mu = torch.empty_like(r), torch.empty(batch, device="cuda")
        times = in_turns({m: (lambda m=m: _k2(libs[m], C, r, b, mu)) for m in k2s_here},
                         "eq_qp")
        rec["k2"].append({"systems": batch, "n": n, "bit_equal_to_before": equal,
                          "device_ms": times})
        log(f"K2 {batch} systems, n={n}: now bit-equal to before {equal}; device us "
            + ", ".join(f"{m} {[round(1e3 * t, 3) for t in ts]}" for m, ts in times.items()))
    if k2s:
        C, r = k2_inputs(gen, 101)
        views = []
        for name in ("k2_now", "k2_before"):
            b, mu = torch.empty_like(r[1:]), torch.empty(100, device="cuda")
            _k2(libs[name], C[1:], r[1:], b, mu)
            views.append((b, mu))
        torch.cuda.synchronize()
        rec["k2_odd_offset_bit_equal"] = all(torch.equal(a, c) for a, c in zip(*views))
        log(f"K2 on views one system in: now bit-equal to before "
            f"{rec['k2_odd_offset_bit_equal']}")

    rec["k3"] = []
    for C, S, M, k in (K3_SHAPES if k3s else ()):
        samples, D = k3_inputs(gen, C, S, M)
        ref = topk_kernel_matrices_plain(samples, D, k)
        outs = (torch.empty(C, S, k, device="cuda"), torch.empty(C, S, k, k, device="cuda"),
                torch.empty(C, S, k, dtype=torch.int32, device="cuda"))
        # an earlier build may take fewer lanes, and staging does not fit at
        # every M: a build takes part where it launches
        here = []
        for name in k3s:
            for t in outs:
                t.fill_(-1)
            try:
                _k3(libs[name], samples, D, k, outs)
            except RuntimeError:
                continue
            torch.cuda.synchronize()
            if not (torch.equal(outs[2], ref[2]) and torch.equal(outs[1], ref[1])):
                raise RuntimeError(f"{name} differs from the twin at {(C, S, M + 1)}, k={k}")
            here.append(name)
        times = in_turns({n: (lambda n=n: _k3(libs[n], samples, D, k, outs)) for n in here},
                         "topk_kernel_matrices")
        rec["k3"].append({"shape": [C, S, M + 1], "k": k, "device_ms": times})
        log(f"K3 {(C, S, M + 1)} k={k}: indices and K_red equal to the twin in {here}; "
            "device us " + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}"
                                     for n, ts in times.items()))

    if k1s:
        rec["k5"] = run_k5(libs, gen, log)
    if prngs:
        rec["prng_beta"] = run_prng(libs, prngs, gen, log)
    kcs = [n for n, (kind, _) in sources.items() if kind == "kc"]
    if kcs:
        # the package's build of kernel (c) beside the others (its "xla" form)
        package.join()
        libs["kc_package"] = _build.library()
        libs["kc_package"].kc_forms = True
        rec["kc"] = run_kc(libs, kcs + ["kc_package"], gen, log)
    kds = [n for n, (kind, _) in sources.items() if kind == "kd"]
    kes = [n for n, (kind, _) in sources.items() if kind == "ke"]
    # kernel (c), launched between (d)'s or (e)'s: the package's build
    if package.is_alive():
        package.join()
    evict_lib = _build.library() if (kds or kes) and not warm_only else None
    if kds:
        rec["kd"] = run_kd(libs, kds, gen, log, evict_lib, warm_only)
    if kes:
        rec["ke"] = run_ke(libs, kes, gen, log, evict_lib, warm_only)
    if "step_now" in libs:
        rec["step_cycles"] = step_cycles(libs["step_now"])
        log(f"critical path of a rollout step, one lane alone (clock64 cycles): "
            f"{rec['step_cycles']}; SM clock {sm_clock_mhz()}")
    khs = [n for n, (kind, _) in sources.items() if kind == "kh"]
    if khs:
        rec["kh"] = run_kh(libs, khs, log, warm_only)
    glue = [n for n, (kind, _) in sources.items() if kind in GLUE_ENTRIES]
    if glue:
        if package.is_alive():
            package.join()
        rec["glue"] = run_glue(libs, glue, gen, log, warm_only)
    if kernels and "forms" in kernels:
        _build.library()
        rec["forms"] = run_forms(gen, log)
    rec["resources"] = RESOURCES
    (out / "kernel_ab.json").write_text(json.dumps(rec, indent=1))
    (out / "kernel_ab.txt").write_text("\n".join(lines) + "\n")
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--before", type=Path, required=True,
                   help="directory with an earlier topk.cu and eq_qp.cu")
    p.add_argument("--diagnose", action="store_true",
                   help="also the diagnostic builds and the latency microbenchmark")
    p.add_argument("--kernels", nargs="*", default=None,
                   help="build and run only these kinds (k1 k2 k3 prng kc kd ke kf k4n kg kh "
                   "micro), or builds, and with forms kernel (c)'s forms against their "
                   "chains from the package's library")
    p.add_argument("--out", type=Path, default=OUT_DIR)
    p.add_argument("--warm_only", action="store_true",
                   help="kernels (d) and (e): warm times only (no L2-cold or evicted "
                   "launches, no build of the package's library)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    run(args.before, args.out, args.diagnose, args.kernels, args.warm_only)


if __name__ == "__main__":
    main()
