#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card: name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``mpc_mmd_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, with CUDA-event
   times of both:
   K1 top-k indices equal exactly at every shape a solve path launches it
   with (``launch_shapes``: the fastrt selection (64, 57, 101), k = 10, its
   iteration-0 batch (1, 64, 101) and elite pick (64, 64), k = 7; Path A's
   "xla" selection (100, 89, 101) and (1, 100, 101), and its elite pick
   (100, 100), k = 11; Path D's (100, 89, 17) and (1, 100, 17), k = 4, and
   the same elite pick; Path E's chunks of 4 and 8 fastrt scenarios,
   (256, 57, 101) and (512, 57, 101), k = 10, their elite picks (256, 64)
   and (512, 64), k = 7, and Path A's chunk of 4, (400, 100), k = 11),
   each with an all-NaN row, NaN lanes, ties, -0.0 against +0.0, +-inf
   and fewer finite lanes than k;
   K2 QP within rtol 1e-4 + atol 1e-5 of the twin run in float64 at every
   path's number and size of systems (3,648, 4,096, 8,900, 10,000 of
   n = 10; Path D's 8,900 and 10,000 of n = 4; Path E's 14,592, 16,384,
   29,184, 32,768 and 40,000 of n = 10);
   K4 rollout within atol 1e-4 at the fastrt solve's shape, at Path D's
   (1,600 lanes x 50 steps from a state per lane in ``mmd_opt``, 400 in
   ``cvar``, ``saa`` and ``mmd_random``), at Path E's chunks (25,600,
   51,200, 40,000 and 4,000 lanes), and at the Monte-Carlo validator's
   (256 solves x 1000 rollouts x 50 steps);
   K3 fused selection at the dynamic workload's shape (100, 100, 101) and
   at the fastrt shape (64, 64, 101), k = 10, at Path D's (100, 100,
   17), k = 4, and at Path E's chunk of 4 Path A scenarios (400, 100,
   101), k = 10, rows with a NaN lane and tied |beta| included: indices
   equal exactly, row sums and K_red within rtol 1e-5 + atol 1e-6;
   K5 one-hot top-k at (64, 57, 101), k = 10: indices and one-hot rows
   equal exactly;
   then the launch floor (the device time of ``fill_`` on one float) and,
   for each kernel at the shapes above (K1 and K2 at every path shape, K3
   and K4 at each timed one), its own device time per launch from
   ``torch.profiler``, its
   bound, and the device time of the one PyTorch call that computes the
   same function, where there is one (``torch.topk`` for K1,
   ``torch.linalg.solve`` of the bordered KKT system for K2; the port
   never calls either);
4. the full-width fastrt ``mmd_opt`` solve (64 candidates x 10 iterations,
   100 mother rollouts, inner CEM 64 samples x 12 iterations): one warm-up
   solve, then 3 scenarios, each with finite coefficients and risk and
   sum(beta) = 1 within 1e-3, with K1, K2 and K4 launched;
5. one outer iteration on the card against the same on the CPU with
   identical draws: the controls of the returned coefficients within 1e-3
   (the JAX package's parity bar) and the coefficients within 1e-3 of
   their scale;
6. Path A, the dynamic cut-in workload in ``mmd_opt`` with the fused
   selection (``MPC_MMD_FUSED_CEM=1``) at full width: 100 candidates x 20
   iterations, 100 mother rollouts, inner CEM 100 samples x 20 iterations,
   Beta noise 0.2; one warm-up solve, then 2 cut-in scenarios of
   ``scenarios.dynamic_cutin``, each checked as in 4, with
   exactly maxiter_cem x beta_cem.maxiter launches each of K3, K2 and K1
   and maxiter_cem of K4 per solve; one more fused solve under
   ``torch.profiler`` (device busy ms, idle share, K3's device ms per
   solve); then 2 solves with the default "xla" selection at the same
   width;
7. Path B, the same workload in ``cvar`` (one warm-up, 2 solves), then one
   solve each of ``mmd_random`` and ``saa``: finite, with K4 launched;
8. one outer iteration of Path A on the card against the CPU with
   identical draws (the CPU run records its Beta draws, the card replays
   them), held as in 5;
9. Path C, the researcher's pipeline through ``mpc_mmd_tpu_torch.cli``:
   a. the sweep CLI over 40 static scenarios (gaussian 0.1, N = 10, 6
      obstacles, ts 50, fastrt budgets) in ``mmd_opt`` and ``cvar``, chunks
      of 20, ``pipeline`` dispatch, into a temporary directory;
   b. the same command again, which must solve nothing (every chunk
      resumes);
   c. ``validate_compare`` of the two stores at n_mc = 1000;
   d. a dynamic cut-in ``cvar`` sweep of 20 scenarios (Beta 0.2) and its
      validation at n_mc = 1000;
   e. the validator alone over 1200 solves (the stored ones repeated) at
      n_mc = 1000: time and peak memory, then once more under
      ``torch.profiler``: device busy time, idle share, device events and
      K4's device time;
   f. the validator on the card against the CPU on 8 stored solves with
      identical draws: counts within +-1 per solve, mean collision % within
      0.1 pp;
   g. one fastrt ``mmd_opt`` solve with the gaussian and one with the
      matern52 MMD kernel: finite, with K1, K2 and K4 launched.
   Each of a-e and g runs with the launch counts set to 0 just before it
   and read just after; a, c, d, e and g fail unless their kernels were
   launched, b if any kernel was;
10. Path D, the on-road stack at full width: ``onroad_workload(num_reduced
   =4, num_obs=4, num_prime=50)``, gaussian 0.1, 100 candidates x 20
   iterations, 16 mother rollouts from 16 noisy initial states, inner CEM
   100 x 20; the frame of step 0 of a curved-route episode built on the
   card as ``run_episode`` builds it (waypoint window, smoothing, path
   parameters, obstacles in Frenet):
   a. (in phase 3) K1, K2, K3 and K4 at its shapes;
   b. ``FrenetSolver`` in ``mmd_opt`` with the "xla" selection: one
      warm-up solve, then 2 solves with finite cx, cy, v_best and
      steering_best and exactly 800 K1, 400 K2 and 20 K4 launches each,
      and one more under ``torch.profiler`` (device busy, idle share);
   c. one solve with ``MPC_MMD_FUSED_CEM=1``: exactly 400 each of K3, K2
      and K1 and 20 of K4;
   d. one solve each of ``cvar``, ``saa``, ``mmd_random`` (20 K4
      launches, nothing else) and ``det`` (no launch);
   e. one outer iteration of ``mmd_opt`` on the card against the CPU with
      identical draws: seed 1's, v_best and steering_best within 1e-3;
      and seed 5's, whose inner CEM meets a near-tie that round-off
      decides (ROADMAP Queue 3), logged and not held;
   f. the closed-loop CLI, ``python -m mpc_mmd_tpu_torch.cli.closedloop
      --route curved --episodes 1 --max_steps 20``, in ``mmd_opt``, ``cvar``
      and ``det``, run in this process: each prints its episode line, the
      first two launch their kernels and ``det`` none.
   Each of b-d and f runs with the launch counts set to 0 just before it
   and read just after.
11. Path E, scenario chunks (``Solver(cfg, scenario_chunk=N).solve_batch``:
   one outer loop over N scenarios, each kernel launched once for the
   chunk) and the exact strategy:
   a. fastrt ``mmd_opt`` (as in 4) over 8 static scenarios at chunks of
      1, 4 and 8, one warm-up chunk each: solves/s, peak memory, and
      launches per chunk, which must equal one solve's exactly; and every
      scenario's cx, cy, risk_obs, res and CEM moments at chunks 4 and 8
      bit-equal to chunk 1's (these scenarios meet near-ties that
      round-off decides, so any change of summation order shows);
   b. a chunk of 4 tie-free blocking scenarios against each scenario
      solved alone on the card, on the same draws: cx, cy and risk_obs
      within 1e-4 of their scale;
   c. Path A fused at chunk 4 over 4 cut-in scenarios: exactly 400 each
      of K3, K2 and K1 and 20 of K4 per chunk;
   d. Path B ``cvar`` at chunk 4: exactly 20 K4 launches per chunk;
   e. the sweep CLI over Path C's 40 static scenarios in ``mmd_opt`` with
      ``--dispatch batch --chunk 8 --scenario_chunk 4``, against Path C's
      ``--dispatch pipeline`` store: the same seeds accepted, cx and cy
      within 1e-4 of their scale; both solves/s;
   f. one fastrt ``mmd_opt`` solve and one Path D ``mmd_opt``
      ``FrenetSolver`` solve with ``solve_strategy="exact"`` under CUDA's
      sync debug mode at "error" (no host sync): finite, with exactly
      maxiter_cem K4 launches and nothing else;
   g. one outer iteration of fastrt exact on the card against the CPU with
      identical draws, held as in 5.
   Each of a, c-f runs with the launch counts set to 0 just before it and
   read just after.

Prints the kernels' JSON record and the card's nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  In the record, ``launches``
counts the launches of the paths' runs (phases 4, 6, 7, 9 a-e, g, 10
b-d, f and 11 a, c-f); K5
is on no path of the package, and its count is that of its own phase.
``launches_per_solve`` splits them by path (per solve; per chunk on
Path E's chunked runs; the validator's per 1200 validations).  The
times, all in milliseconds at ``shape``:

- ``ms``: CUDA events around a Python loop of 50 wrapper calls, over 50.
  It includes the wrapper's host work (checks, ``torch.empty``, the
  ``ctypes`` call), which sets a floor of tens of microseconds: an upper
  bound on the kernel, not its time.
- ``plain_ms``: the same for the plain PyTorch twin.
- ``device_ms``: the kernel's own device time per launch, from
  ``torch.profiler`` over 20 launches.
- ``bound_ms``: the larger of the bytes (each input read once, each output
  written once) over 3.35 TB/s and the float32 operations over 67 TFLOP/s
  (``bound_by`` says which).
- ``library_ms``: the device time per call of the library call named in
  ``library``, or null where no single call computes the function
  (``library`` then says so).

K4 also carries ``largest``: the same at the validator's 256,000 lanes.
K1, K2, K3 and K4 carry ``shapes``: for every path shape timed its device
time, bound, plain twin's time, library time and launches per solve per
path (for each path a shape names, the sum over the shapes must equal the
launches that path's run counted).  Every row carries
``launch_floor_ms``.
Exits non-zero, with no result, when there is no CUDA card or the package
is not beside it.
"""

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=50, warmup=3):
    """Mean milliseconds per call, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores


def bound(nbytes, ops):
    """Least milliseconds the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profiled_ms(torch, fn, reps=20, match=None):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``.

    With ``match`` (a kernel's name), the device events whose name holds it
    are the kernel's launches, one a call, and their summed time over their
    number is the kernel's own device time per launch.  The profiler now and
    then records no device event in a session, or drops a launch's record:
    up to five sessions are tried for one that records all ``reps``; failing
    that, the fullest session is used if it recorded at least half of them
    (never more than ``reps``: more would mean ``match`` names another
    kernel too).  Without ``match``, every device event of the window
    counts, over ``reps``: a library call's device time, whatever kernels
    it launches.  Each session opens with a short ``spin_kernel``, left out
    of the count, so that no launch under test is the session's first.
    Returns (ms, names seen).
    """
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name
              and (match is None or match in e.name)]
        names = sorted({e.name for e in ev})
        if match is not None and len(ev) > reps:
            fail(f"profiler: {len(ev)} device events named {match!r} for {reps} "
                 f"launches ({names})")
        if len(ev) > len(best):
            best = ev
        if ev and (match is None or len(ev) == reps):
            break
    names = sorted({e.name for e in best})
    if not best or (match is not None and 2 * len(best) < reps):
        fail(f"profiler: at most {len(best)} device events named {match!r} for "
             f"{reps} launches in 5 sessions ({names})")
    if match is not None and len(best) < reps:
        log(f"profiler: {len(best)} of {reps} launches of {match!r} recorded in "
            f"the fullest of 5 sessions; the time is per recorded launch")
    per = len(best) if match is not None else reps
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / per, names


def f32_bytes(*tensors):
    return sum(4 * t.numel() for t in tensors)


def launch_shapes(paths):
    """K1's and K2's launch shapes on each path, from its configuration.

    ``paths`` maps a path's name to (config, selection) or, for a path
    that solves scenario chunks, (config, selection, scenarios per chunk):
    a chunk of N scenarios runs one outer loop over its N x num_batch
    candidates.  Returns (k1, k2): k1 maps (shape, k, kwargs) and k2
    (number of systems, n) to {path: launches per solve (per chunk)}.
    The "xla" selection runs with elite-carry:
    the top-k of the shared iteration-0 batch (1, S, M+1) and the QP of all
    C x S rows once per outer iteration, then the S - n_el fresh rows of
    every candidate; the "fused" one recomputes every row with K3 and
    solves C x S systems.  Both pick the n_el elites of every candidate's S
    costs in every inner iteration.
    """
    k1, k2 = {}, {}
    for path, (cfg, selection, *chunk) in paths.items():
        b, C = cfg.beta_cem, cfg.cem.num_batch * (chunk[0] if chunk else 1)
        S, n_el, it, outer = (b.num_samples_cem, b.num_ellite, b.maxiter,
                              cfg.cem.maxiter_cem)
        M, k = cfg.risk.num_mother, cfg.risk.num_reduced
        sel = (("absolute", True), ("slice_to", M))
        # K2 is keyed by (systems, n): two paths may solve as many systems
        # of another size
        if selection == "fused":
            t1 = {}
            t2 = {(C * S, k): it * outer}
        else:
            t1 = {((C, S - n_el, M + 1), k, sel): (it - 1) * outer,
                  ((1, S, M + 1), k, sel): outer}
            t2 = {(C * (S - n_el), k): (it - 1) * outer, (C * S, k): outer}
        t1[((C, S), n_el, ())] = it * outer
        for table, add in ((k1, t1), (k2, t2)):
            for key, n in add.items():
                table.setdefault(key, {})[path] = n
    return k1, k2


def check_launch_shapes(tables, per_solve):
    """The launches per solve of every path that a kernel's shapes name,
    summed over those shapes, must be those its run counted.  ``tables``
    maps a kernel's name to {shape: {path: launches per solve}}."""
    for name, table in tables.items():
        for path in {p for at in table.values() for p in at}:
            want = sum(at.get(path, 0) for at in table.values())
            if per_solve[path].get(name, 0) != want:
                fail(f"{name} on {path}: {per_solve[path].get(name)} launches per "
                     f"solve, but its shapes add up to {want}")


def check_topk(torch, ops, topk_plain, gen, shapes):
    """K1 at every path shape (``launch_shapes``), with the edge rows of
    ``kernel_ab.k1_inputs`` (all NaN, NaN lanes, ties, -0.0 against +0.0,
    +-inf, fewer finite lanes than k): indices equal to the twin's exactly.  Returns the selection shape's
    record, with the other shapes under ``cases``."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import k1_inputs
    cases = []
    for (shape, k, kw), at in shapes.items():
        kw = dict(kw)
        x = k1_inputs(gen, shape, k, bool(kw))   # the elite pick ranks -cost
        got = ops.topk_indices(x, k, **kw)
        ref = topk_plain(x, k, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K1 topk_indices disagrees with its plain twin at {shape}, k={k} "
                 f"(rows {(got != ref).any(-1).nonzero()[:4].tolist()})")
        m = kw.get("slice_to", shape[-1])
        rows = x.numel() // shape[-1]
        ranked = x[..., :m].abs() if kw.get("absolute") else x[..., :m]
        ranked = ranked.contiguous()                   # outside the timed window
        cases.append(dict(
            shape=f"{shape}, k={k}" + (f", |x| of the first {m} lanes" if kw else ""),
            call=(lambda x=x, k=k, kw=kw: ops.topk_indices(x, k, **kw)),
            match="topk_rounds_kernel", nbytes=f32_bytes(x) + 4 * rows * k,
            ops=rows * k * m, launches_per_solve=at,
            library=(f"torch.topk on the {'|x| slice' if kw else 'rows'}",
                     lambda r=ranked, k=k: torch.topk(r, k, dim=-1)),
            plain_ms=cuda_ms(torch, lambda: topk_plain(x, k, **kw))))
    main = dict(cases[0], max_abs_err=0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_eq_qp(torch, ops, qp_plain, dev, gen, systems):
    """K2 at every path's number and size of systems (``launch_shapes``),
    built as the inner CEM builds them (``kernel_ab.k2_inputs``), each
    within rtol 1e-4 + atol 1e-5 of the twin run in float64.  Returns the
    fastrt selection's record, with the others under ``cases``."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import k2_inputs
    cases, err = [], 0.0
    for (count, n), at in systems.items():
        C, r = k2_inputs(gen, count, n)
        b, mu = ops.eq_qp_solve(C, r)
        b64, mu64 = qp_plain(C.double(), r.double())
        torch.cuda.synchronize()
        for name, got, ref in (("b", b, b64), ("mu", mu, mu64)):
            bad = (got.double() - ref).abs() > 1e-4 * ref.abs() + 1e-5
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                fail(f"K2 eq_qp_solve {name} outside rtol 1e-4 + atol 1e-5 of the "
                     f"float64 twin at {int(bad.sum())} entries ({count} systems)")
        err = max(err, float((b.double() - b64).abs().max()),
                  float((mu.double() - mu64).abs().max()))
        # the bordered (n+1) x (n+1) KKT system [[C, 1], [1^T, 0]] [b; mu] =
        # [r; 1], built outside the timed window
        n = C.shape[-1]
        kkt = torch.zeros(C.shape[:-2] + (n + 1, n + 1), device=dev)
        kkt[..., :n, :n] = C
        kkt[..., :n, n] = 1.0
        kkt[..., n, :n] = 1.0
        rhs = torch.cat((r, torch.ones_like(r[..., :1])), dim=-1)[..., None]
        cases.append(dict(
            shape=f"{count} systems, n={n}",
            call=(lambda C=C, r=r: ops.eq_qp_solve(C, r)), match="eq_qp_kernel",
            nbytes=f32_bytes(C, r, b, mu), ops=count * (n ** 3 // 3 + 4 * n * n),
            launches_per_solve=at,
            library=("torch.linalg.solve on the bordered (n+1)x(n+1) KKT system",
                     lambda kkt=kkt, rhs=rhs: torch.linalg.solve(kkt, rhs)),
            plain_ms=cuda_ms(torch, lambda: qp_plain(C, r), reps=10)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_rollout(torch, ops, rollout_plain, dev, gen, lanes=6400,
                  per_lane=False, launches_per_solve=None):
    """K4 on ``lanes`` x 50 steps from one shared initial state (6400 in a
    fastrt outer iteration, 25,600 to 51,200 in one of a scenario chunk,
    256,000 in a chunk of the MC validator) or,
    with ``per_lane``, from a state per lane (1,600 in an on-road
    ``mmd_opt`` outer iteration: 100 candidates x 16 mother rollouts, each
    from its noisy initial state; 400 in the other modes' 100 x 4), within
    atol 1e-4 of the twin."""
    acc = (1.0 + 0.5 * torch.randn(lanes, 50, device=dev, generator=gen)).contiguous()
    steer = (0.1 * torch.randn(lanes, 50, device=dev, generator=gen)).contiguous()
    s0 = torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device=dev)
    if per_lane:
        s0 = (s0 + torch.tensor([0.05, 0.1, 0.5, 0.1, 0.02], device=dev)
              * torch.randn(lanes, 5, device=dev, generator=gen)).contiguous()
    args = (acc, steer, s0, 0.15, 2.5)
    x, y = ops.fused_rollout(*args)
    xr, yr = rollout_plain(*args)
    torch.cuda.synchronize()
    err = max(float((x - xr).abs().max()), float((y - yr).abs().max()))
    if not err <= 1e-4:
        fail(f"K4 fused_rollout differs from its plain twin by {err} (> 1e-4) "
             f"at {lanes} lanes{', a state per lane' if per_lane else ''}")
    return dict(max_abs_err=err, ms=cuda_ms(torch, lambda: ops.fused_rollout(*args)),
                plain_ms=cuda_ms(torch, lambda: rollout_plain(*args), reps=10),
                shape=f"{lanes} lanes x 50 steps, "
                      + ("a state per lane" if per_lane else "one shared state"),
                call=lambda: ops.fused_rollout(*args), match="rollout_kernel",
                # two inputs read, two outputs written; ~16 float32
                # operations a lane-step (tan, cos, sin and sqrt as one each)
                nbytes=f32_bytes(acc, steer, s0, x, y), ops=16 * acc.numel(),
                launches_per_solve=launches_per_solve,
                library=("no single call", None))


def check_fused_selection(torch, ops, plain, dev, gen):
    """K3 at the dynamic workload's (100, 100, 101) and the fastrt
    (64, 64, 101) selection shapes, k = 10, at the on-road (100, 100,
    17), k = 4, and at Path A's chunk of 4 scenarios (400, 100, 101); D
    from random features.  Returns the dynamic shape's record, with the
    on-road and chunk ones under ``cases``."""
    err = 0.0
    cases = []
    for C, S, M, k, at in ((100, 100, 100, 10, {"path_a_fused": 400}),
                           (64, 64, 100, 10, None),
                           (100, 100, 16, 4, {"path_d_fused": 400}),
                           (400, 100, 100, 10, {"path_e_fused4": 400})):
        samples = torch.randn(C, S, M + 1, device=dev, generator=gen)
        samples[..., M] = samples[..., M].abs() * 3 + 0.01
        samples[0, 1, 7] = float("nan")                      # NaN lane
        samples[0, 2, :M] = torch.round(samples[0, 2, :M])   # tied |beta|
        f = torch.randn(C, M, 22, device=dev, generator=gen)
        D = (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1).contiguous()
        got = ops.topk_kernel_matrices(samples, D, k)
        ref = plain(samples, D, k)
        torch.cuda.synchronize()
        if not torch.equal(got[2], ref[2]) or not bool((got[2][0, 1] == M).all()):
            fail(f"K3 topk_kernel_matrices indices differ from the twin at "
                 f"{(C, S, M + 1)}, k={k}")
        for name, g, r in (("row_sum", got[0], ref[0]), ("K_red", got[1], ref[1])):
            bad = (g - r).abs() > 1e-5 * r.abs() + 1e-6
            if bool(bad.any()) or not bool(torch.isfinite(g).all()):
                fail(f"K3 {name} outside rtol 1e-5 + atol 1e-6 of the twin at "
                     f"{int(bad.sum())} entries, shape {(C, S, M + 1)}, k={k}")
            err = max(err, float((g - r).abs().max()))
        if at is None:
            continue
        call = (lambda s=samples, d=D, k=k: ops.topk_kernel_matrices(s, d, k))
        cases.append(dict(
            shape=f"({C}, {S}, {M + 1}), k={k}", call=call,
            match="topk_kernel_matrices_kernel", launches_per_solve=at,
            nbytes=f32_bytes(samples, D, *got),
            # a division, an exp and an add per (row, selected row, column)
            ops=3 * C * S * k * M, library=("no single call", None),
            plain_ms=cuda_ms(torch, lambda s=samples, d=D, k=k: plain(s, d, k),
                             reps=10)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_topk_onehot(torch, ops, plain, dev, gen):
    """K5 at (64, 57, 101), k = 10, ranking |x| over the first 100 lanes."""
    x = torch.randn(64, 57, 101, device=dev, generator=gen)
    x[0, 0] = float("nan")
    x[1] = torch.round(x[1] * 2) / 2
    kw = dict(absolute=True, slice_to=100)
    idx, oh = ops.topk_onehot(x, 10, **kw)
    ridx, roh = plain(x, 10, **kw)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx) or not torch.equal(oh, roh):
        fail("K5 topk_onehot differs from its plain twin")
    call = lambda: ops.topk_onehot(x, 10, **kw)
    return dict(max_abs_err=0.0, ms=cuda_ms(torch, call),
                plain_ms=cuda_ms(torch, lambda: plain(x, 10, **kw)),
                shape="(64, 57, 101), k=10, |x| of the first 100 lanes",
                call=call, match="topk_rounds_kernel", nbytes=f32_bytes(x, idx, oh),
                ops=idx.numel() * 100, library=("no single call", None))


def measure(torch, name, rec):
    """Adds to a kernel's check result its device time per launch, its bound
    and its library call's device time, and logs them; the same for each of
    its ``cases`` (K1's and K2's other path shapes)."""
    for case in rec.get("cases", [rec]):
        case["device_ms"], names = profiled_ms(torch, case["call"], match=case["match"])
        case["bound_ms"], case["bound_by"] = bound(case["nbytes"], case["ops"])
        what, lib = case["library"]
        case["library_ms"] = profiled_ms(torch, lib)[0] if lib else None
        per_solve = case.get("launches_per_solve")
        log(f"{name} at {case['shape']}: device {case['device_ms']:.4f} ms per launch "
            f"({names[0][:60]}), bound {case['bound_ms']:.4f} ms by {case['bound_by']} "
            f"({case['nbytes'] / 1e6:.2f} MB, {case['ops']:.3g} ops), "
            f"{100 * case['bound_ms'] / case['device_ms']:.1f} % of it; library "
            f"{what}: {case['library_ms']}"
            + (f"; launches per solve {per_solve}" if per_solve else ""))
    for key in ("device_ms", "bound_ms", "bound_by", "library_ms"):
        rec[key] = rec.get("cases", [rec])[0][key]


def kernel_record(ops, launches, per_solve, floor_ms, k1, k2, k3, k4, k5):
    """The kernels' JSON record (see the module docstring); ``k4`` is the
    pair (main path shape, validator shape)."""
    record = []
    for fn, src_file, tpu, (rec, largest) in (
            (ops.topk_indices, "topk.cu", "mpc_mmd_tpu/ops/topk_pallas.py:116",
             (k1, None)),
            (ops.eq_qp_solve, "eq_qp.cu", "mpc_mmd_tpu/ops/qp_pallas.py:109",
             (k2, None)),
            (ops.topk_kernel_matrices, "topk_kernel.cu",
             "mpc_mmd_tpu/ops/topk_kernel_pallas.py:87", (k3, None)),
            (ops.fused_rollout, "rollout.cu",
             "mpc_mmd_tpu/ops/rollout_pallas.py:101", k4),
            (ops.topk_onehot, "topk.cu", "mpc_mmd_tpu/ops/topk_pallas.py:146",
             (k5, None))):
        name = fn.__name__
        row = {"name": name, "route": "cuda",
               "source": f"mpc_mmd_tpu_torch/csrc/{src_file}", "replaces": tpu,
               "launches": launches[name],
               "launches_per_solve": {p: n[name] for p, n in per_solve.items()
                                      if n.get(name)},
               "max_abs_err": max(rec["max_abs_err"],
                                  largest["max_abs_err"] if largest else 0.0),
               "shape": rec["shape"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
               "device_ms": rec["device_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
               "library": rec["library"][0], "launch_floor_ms": floor_ms}
        if "cases" in rec:
            row["shapes"] = [{k: c[k] for k in (
                "shape", "device_ms", "bound_ms", "bound_by", "plain_ms",
                "library_ms", "launches_per_solve")} for c in rec["cases"]]
        if largest:
            row["largest"] = {k: largest[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms",
                "bound_by")}
        record.append(row)
    return record


def obstacle_scenarios(torch, n, num_obs, tot_time, blocking=False):
    """bench.py's static scenarios (obstacles on a 35-75 m grid in either
    lane), or with ``blocking`` the tie-free near-field ones of
    tests/conftest.py; trajectories (num_obs, num) on tot_time's device."""
    from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
    rng = np.random.default_rng(0)
    grid = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], np.float32)
    zeros = torch.zeros(num_obs, device=tot_time.device)
    out = []
    for i in range(n):
        if blocking:
            x0 = np.resize([8.0 + 0.37 * i, 13.0 + 0.53 * i], num_obs)
            y0 = np.resize([1.75 - 0.11 * i, 0.6 + 0.13 * i], num_obs)
        else:
            x0 = rng.choice(grid, num_obs, replace=False)
            y0 = rng.choice(np.array([-1.75, 1.75]), num_obs)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=tot_time.device)
        xt, yt, _ = constant_velocity_obstacles(as_t(x0), as_t(y0), zeros,
                                                zeros, zeros, tot_time)
        out.append((xt, yt))
    return out


INIT = [0.0, 1.75, 5.0, 0.0, 0.0, 0.0]
MEAN = [15.0] * 4 + [0.0] * 4
COV = np.diag([20.0] * 4 + [100.0] * 4)


def check_solve(result, cfg):
    for name in ("cx", "cy"):
        t = getattr(result, name)
        if tuple(t.shape) != (cfg.horizon.nvar,) or not bool(t.isfinite().all()):
            fail(f"solve returned {name} of shape {tuple(t.shape)} with "
                 f"non-finite values")
    if not math.isfinite(float(result.risk_obs)):
        fail(f"solve returned risk_obs {float(result.risk_obs)}")
    s = float(result.beta.sum())
    if abs(s - 1.0) > 1e-3:
        fail(f"sum(beta) = {s}, not 1 within 1e-3")


def cuda_vs_cpu(torch, cfg1, args, label):
    """One outer iteration on the card and on the CPU with identical draws
    (Beta draws recorded on the CPU and replayed on the card)."""
    from mpc_mmd_tpu_torch import Solver
    from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, record_solve_draws
    arrays, record = record_solve_draws(TorchNoise(torch.Generator(), "cpu"),
                                        cfg1, 5)
    out = {}
    for name in ("cpu", "cuda"):
        s = Solver(cfg1, device=name, noise=FixedNoise(arrays, name, record))
        res = s.solve(5, *args)
        out[name] = (s.ws, [t.cpu() for t in (res.cx, res.cy)],
                     float(res.risk_obs))
    ws_cpu = out["cpu"][0]
    (cxg, cyg), (cxc, cyc) = out["cuda"][1], out["cpu"][1]
    ag, sg = controls(ws_cpu, cfg1, cxg, cyg)
    ac, sc = controls(ws_cpu, cfg1, cxc, cyc)
    ctrl_err = max(float((ag - ac).abs().max()), float((sg - sc).abs().max()))
    scale = max(1.0, float(cxc.abs().max()), float(cyc.abs().max()))
    coef_err = max(float((cxg - cxc).abs().max()), float((cyg - cyc).abs().max()))
    log(f"{label} cuda vs cpu, one outer iteration: controls max diff "
        f"{ctrl_err:.3e}, coefficients max diff {coef_err:.3e} (scale "
        f"{scale:.1f}), risk_obs {out['cuda'][2]:.6f} vs {out['cpu'][2]:.6f}")
    if not ctrl_err <= 1e-3:
        fail(f"{label}: controls differ between cuda and cpu by {ctrl_err} (> 1e-3)")
    if not coef_err <= 1e-3 * scale:
        fail(f"{label}: coefficients differ between cuda and cpu by {coef_err} "
             f"(> 1e-3 x {scale})")


def timed_solves(torch, ops, solver, cfg, calls, label, path_kernels):
    """Runs ``calls`` (seed, scenario) solves with the launch counts set to 0
    just before and read just after; checks each solve and that every
    kernel of ``path_kernels`` was launched.  Returns the counts."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    t0 = time.perf_counter()
    for seed, args in calls:
        ts = time.perf_counter()
        r = solver.solve(seed, *args)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - ts)
        check_solve(r, cfg)
    rate = len(calls) / (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    missing = [fn.__name__ for fn in path_kernels if launches[fn.__name__] < 1]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}; {launches}")
    per_solve = {k: v / len(calls) for k, v in launches.items() if v}
    log(f"{label}: {rate:.2f} solves/s, latencies "
        f"{[round(1e3 * x, 1) for x in lat]} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches per "
        f"solve {per_solve}; last risk_obs {float(r.risk_obs):.4f}")
    return launches


def traced(fn):
    """``fn()`` under ``torch.profiler`` (``device_trace``): returns its
    result, the trace summary (wall ms, device busy ms, idle share, device
    events, top kernels) and the profiler."""
    from mpc_mmd_tpu_torch.utils.observability import device_trace
    with tempfile.TemporaryDirectory() as trace_dir:
        with device_trace(trace_dir) as prof:
            r = fn()
        with open(glob.glob(os.path.join(trace_dir, "summary_*.json"))[0]) as f:
            summary = json.load(f)
    return r, summary, prof


def trace_path_a(torch, ops, solver, cfg, call):
    """One Path A fused solve under ``torch.profiler``: device busy ms, idle
    share and K3's device ms per solve."""
    r, summary, prof = traced(lambda: solver.solve(call[0], *call[1]))
    check_solve(r, cfg)
    k3 = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "topk_kernel_matrices_kernel" in e.name]
    k3_ms = sum(e.time_range.elapsed_us() for e in k3) / 1e3
    n_inner = cfg.cem.maxiter_cem * cfg.beta_cem.maxiter
    # the launches themselves are counted exactly by the wrapper (the path's
    # check); the profiler may drop a record, never add one
    if not n_inner <= 2 * len(k3) <= 2 * n_inner:
        fail(f"Path A trace: {len(k3)} K3 device events in one solve of "
             f"{n_inner} launches")
    log(f"Path A fused, one solve under torch.profiler: {summary['wall_ms']:.1f} ms "
        f"wall, device busy {summary['device_busy_ms']:.2f} ms, idle share "
        f"{summary['idle_share']:.3f}, {summary['device_events']} device events; K3 "
        f"{k3_ms:.3f} ms over {len(k3)} launches (PERF.md's profile before the K3 "
        f"redesign: busy 90.9 ms, idle 0.786, K3 33.2 ms over 400); top "
        f"{summary['top'][:4]}")


def controls(ws, cfg, cx, cy):
    from mpc_mmd_tpu_torch.dynamics import controls_from_trajectory
    T = cfg.horizon.num_prime
    a, s = controls_from_trajectory((ws.Pdot @ cx)[None], (ws.Pdot @ cy)[None],
                                    (ws.Pddot @ cx)[None], (ws.Pddot @ cy)[None],
                                    cfg.horizon.dt, cfg.vehicle.wheel_base)
    return a[0, :T], s[0, :T]


def counted(torch, ops, label, path_kernels, fn):
    """Runs ``fn()`` with the launch counts set to 0 just before and read
    just after, and the peak memory reset; fails unless every kernel of
    ``path_kernels`` was launched.  Returns (result, seconds, launches)."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in ops.KERNELS}
    missing = [f.__name__ for f in path_kernels if launches[f.__name__] < 1]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}; {launches}")
    return out, secs, launches


SWEEP_FLAGS = ["--workload", "static", "--noise_levels", "0.1", "--noises",
               "gaussian", "--num_reduced_sets", "10", "--num_obs", "6",
               "--num_prime", "50", "--num_configs", "40", "--chunk", "20",
               "--outer_budget", "64x10", "--inner_budget", "64x12",
               "--dispatch", "pipeline", "--device", "cuda"]


def path_c(torch, ops, dev, work, per_solve):
    """Phase 9: sweep, resume, validate, the validator at 1200 solves, card
    vs CPU, and the gaussian / matern52 kernels.  Returns the launch counts
    of the path's runs and {mode: (store root, seconds)} of its sweeps;
    adds the sweeps' launches per solve and the validator's per 1200
    validations to ``per_solve``."""
    from mpc_mmd_tpu_torch import Solver, fastrt_workload
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.cli import validate as validate_cli
    from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise
    from mpc_mmd_tpu_torch.qp import build_workspace
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore
    from mpc_mmd_tpu_torch.utils.observability import device_trace
    from mpc_mmd_tpu_torch.validate import CHUNK, make_validator

    K1, K2, K4 = ops.topk_indices, ops.eq_qp_solve, ops.fused_rollout
    data = os.path.join(work, "data")
    path_launches, roots, sweeps = [], {}, {}

    # a. the sweep CLI, one mode per command
    for mode in ("mmd_opt", "cvar"):
        _, secs, got = counted(
            torch, ops, f"Path C sweep {mode}",
            (K1, K2, K4) if mode == "mmd_opt" else (K4,),
            lambda: sweep_cli.main(["--costs", mode, "--out", data, *SWEEP_FLAGS]))
        found = glob.glob(os.path.join(data, "static", "*", "*", "*", f"{mode}_*"))
        if len(found) != 1:
            fail(f"Path C sweep {mode}: expected one store, found {found}")
        roots[mode] = found[0]
        store = ResultStore(roots[mode])
        arrays = store.concatenated()
        if store.done_chunks() != [0, 1] or not np.all(np.isfinite(arrays["cx"])):
            fail(f"Path C sweep {mode}: chunks {store.done_chunks()}, or "
                 "non-finite coefficients")
        log(f"Path C sweep {mode} (static, gaussian 0.1, fastrt budgets, 40 "
            f"scenarios, pipeline): {secs:.2f} s, {40 / secs:.2f} solves/s, "
            f"accepted {len(arrays['cx'])}/40, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches {got}")
        path_launches.append(got)
        per_solve[f"sweep_{mode}"] = {k: v / 40 for k, v in got.items()}
        sweeps[mode] = (roots[mode], secs)

    # b. the same commands again: every chunk resumes, nothing is solved
    chunk_files = {r: sorted(os.listdir(r)) for r in roots.values()}
    stamps = {r: [os.stat(os.path.join(r, f)).st_mtime_ns for f in chunk_files[r]]
              for r in roots.values()}
    _, secs, got = counted(torch, ops, "Path C resume", (), lambda: [
        sweep_cli.main(["--costs", m, "--out", data, *SWEEP_FLAGS]) for m in roots])
    if any(got.values()) or any(
            sorted(os.listdir(r)) != chunk_files[r]
            or [os.stat(os.path.join(r, f)).st_mtime_ns for f in chunk_files[r]]
            != stamps[r] for r in roots.values()):
        fail(f"Path C resume: the rerun solved or rewrote something ({got})")
    log(f"Path C resume: both sweeps again in {secs:.2f} s, no solve, no launch")

    # c. paired validation of the two modes
    res, secs, got = counted(
        torch, ops, "Path C validate_compare", (K4,),
        lambda: validate_cli.validate_compare(
            [roots["mmd_opt"], roots["cvar"]], n_mc=1000, seed=0,
            out_root=os.path.join(work, "stats"), device=dev))
    if res["n_common"] < 1:
        fail("Path C validate_compare: no scenario accepted by both modes")
    pair = res["pairs"]["mmd_opt_vs_cvar"]
    log(f"Path C validate_compare at n_mc=1000: n_common {res['n_common']}, "
        f"collision % mmd_opt {res['modes']['mmd_opt']['coll_pct_mean']:.4f}, "
        f"cvar {res['modes']['cvar']['coll_pct_mean']:.4f}, Wilcoxon p "
        f"{pair['p_wilcoxon']}; {secs:.2f} s; launches {got}")
    path_launches.append(got)

    # d. dynamic cut-in cvar sweep (every solve kept) and its validation
    dyn, secs, got = counted(
        torch, ops, "Path C dynamic sweep", (K4,),
        lambda: sweep_cli.run_sweep("dynamic", "cvar", "beta", 0.2, 10, 6, 50,
                                    20, data, chunk=20, dispatch="pipeline",
                                    accept_all=True, device=dev))
    risk = dyn.concatenated()["risk_obs"]
    path_launches.append(got)
    stats, vsecs, got = counted(
        torch, ops, "Path C dynamic validation", (K4,),
        lambda: validate_cli.validate_store(dyn.root, n_mc=1000, seed=0,
                                            out_root=os.path.join(work, "dyn"),
                                            device=dev))
    if stats["n_solves"] != 20:
        fail(f"Path C dynamic validation: {stats['n_solves']} solves, not 20")
    log(f"Path C dynamic sweep (cut-in, beta 0.2, cvar, 100 x 20 outer): "
        f"{secs:.2f} s, {20 / secs:.2f} solves/s, {int(np.sum(risk <= 1e-5))}/20 "
        f"under the acceptance threshold; validation at n_mc=1000 in "
        f"{vsecs:.2f} s, collision % {stats['coll_pct_mean']:.4f} "
        f"(p95 {stats['coll_pct_p95']:.4f}); launches {got}")
    path_launches.append(got)

    # e. the validator alone over 1200 solves
    store = ResultStore(roots["mmd_opt"])
    cfg = validate_cli.config_of(store.meta)
    arrays = store.concatenated()
    idx = np.resize(np.arange(len(arrays["cx"])), 1200)
    args = [arrays[f][idx] for f in ("cx", "cy")] + [arrays["init_state"][0]] + \
        [arrays[f][idx] for f in ("x_obs_traj", "y_obs_traj")]
    validator = make_validator(cfg, build_workspace(cfg, dev), n_mc=1000)
    validator(*(a[:8] if a.ndim > 1 else a for a in args))        # warm-up
    out, secs, got = counted(
        torch, ops, "Path C validator", (K4,),
        lambda: [t.cpu().numpy() for t in validator(*args)])
    n_k4 = -(-1200 // CHUNK)
    if got["fused_rollout"] != n_k4 or out[0].shape != (1200,) or \
            not (0 <= out[0].min() and out[0].max() <= 1000):
        fail(f"Path C validator: K4 launches {got['fused_rollout']} (expected "
             f"{n_k4}) or counts out of range")
    log(f"Path C validator: 1200 solves x 1000 rollouts x 50 steps in "
        f"{secs:.3f} s, {1200 / secs:.1f} validations/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, {n_k4} K4 "
        f"launches of up to {CHUNK * 1000} lanes; mean collision % "
        f"{out[0].mean() / 10:.4f}")
    path_launches.append(got)
    per_solve["validator_1200"] = dict(got)
    trace_dir = os.path.join(work, "trace")
    with device_trace(trace_dir):
        validator(*args)
    with open(glob.glob(os.path.join(trace_dir, "summary_*.json"))[0]) as f:
        prof = json.load(f)
    k4_ms = sum(ms for name, ms, _ in prof["top"] if "rollout_kernel" in name)
    log(f"Path C validator under torch.profiler: {prof['wall_ms']:.1f} ms wall, "
        f"device busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}), {prof['device_events']} device events, "
        f"K4 {k4_ms:.3f} ms; top {prof['top'][:4]}")

    # f. the validator on the card against the CPU, identical draws
    T = cfg.horizon.num_prime
    draws = TorchNoise(torch.Generator(), "cpu").mc_draws(0, range(8), 1000, T)
    arrays8 = dict(zip(("mc_eps_acc", "mc_eps_steer", "mc_eps_const"),
                       (d.numpy() for d in draws)))
    counts = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        v = make_validator(cfg, build_workspace(cfg, device), 1000,
                           FixedNoise(arrays8, device))
        counts[name] = [t.cpu().numpy().astype(np.int64) for t in v(
            *(a[:8] if a.ndim > 1 else a for a in args))[:2]]
    d_coll = np.abs(counts["cuda"][0] - counts["cpu"][0]).max()
    d_lane = np.abs(counts["cuda"][1] - counts["cpu"][1]).max()
    d_pct = abs(counts["cuda"][0].mean() - counts["cpu"][0].mean()) / 10
    log(f"Path C validator cuda vs cpu, 8 solves, identical draws: coll_count "
        f"max diff {d_coll}, lane_count max diff {d_lane}, mean collision % "
        f"{counts['cuda'][0].mean() / 10:.4f} vs {counts['cpu'][0].mean() / 10:.4f}")
    if d_coll > 1 or d_lane > 1 or d_pct > 0.1:
        fail("Path C: the validator on the card disagrees with the CPU beyond "
             "+-1 per solve or 0.1 pp")

    # g. the gaussian and matern52 MMD kernels at the fastrt width
    for kind in ("gaussian", "matern52"):
        cfg_k = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50)
        cfg_k = cfg_k.replace(risk=dataclasses.replace(cfg_k.risk, kernel=kind))
        solver = Solver(cfg_k, device=dev)
        scen = obstacle_scenarios(torch, 1, 6, solver.ws.tot_time)[0]
        r, secs, got = counted(torch, ops, f"Path C {kind} kernel", (K1, K2, K4),
                               lambda: solver.solve(0, INIT, MEAN, COV, *scen, 15.0))
        check_solve(r, cfg_k)
        log(f"Path C fastrt mmd_opt, {kind} kernel: {1e3 * secs:.1f} ms (first "
            f"solve), risk_obs {float(r.risk_obs):.4f}; launches {got}")
        path_launches.append(got)
    return path_launches, sweeps


# Path D's world: two obstacles block both lanes 12-18 m ahead, two more
# further on, so every candidate meets a distinct risk
ONROAD_OBSTACLES = ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5))


def onroad_problem(torch, cfg, dev):
    """Step 0 of an on-road episode, built on the card as ``run_episode``
    builds it: the curved route's waypoint window, smoothed, its path
    parameters, the obstacles in Frenet.  Returns the arguments of
    ``FrenetSolver.solve`` after ``idx_mpc``."""
    from mpc_mmd_tpu_torch.closedloop import (SyntheticPlant, local_problem,
                                              make_route)
    from mpc_mmd_tpu_torch.frenet import build_smoother
    plant = SyntheticPlant(cfg, make_route("curved"), ONROAD_OBSTACLES)
    tot_time = torch.as_tensor(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num),
                               dtype=torch.float32, device=dev)
    frame, x_obs, y_obs, init = local_problem(
        cfg, plant, build_smoother(cfg.frenet.num_path, device=dev), tot_time)
    return init, MEAN, COV, x_obs, y_obs, 15.0, frame


def check_frenet_solve(r, cfg, label):
    for name, n in (("cx", cfg.horizon.nvar), ("cy", cfg.horizon.nvar),
                    ("v_best", cfg.horizon.num), ("steering_best", cfg.horizon.num)):
        t = getattr(r, name)
        if tuple(t.shape) != (n,) or not bool(t.isfinite().all()):
            fail(f"{label}: {name} of shape {tuple(t.shape)} with non-finite values")
    if not math.isfinite(float(r.risk_obs)):
        fail(f"{label}: risk_obs {float(r.risk_obs)}")


def path_d(torch, ops, dev, cfg, per_solve):
    """Phase 10: the on-road stack at full width (see the module
    docstring).  Returns the launch counts of its runs; adds each run's
    launches per solve to ``per_solve``."""
    import contextlib
    import io
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.cli import closedloop as closedloop_cli
    from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise, record_solve_draws

    K1, K2, K3, K4 = (ops.topk_indices, ops.eq_qp_solve, ops.topk_kernel_matrices,
                      ops.fused_rollout)
    n_inner = cfg.cem.maxiter_cem * cfg.beta_cem.maxiter
    outer = cfg.cem.maxiter_cem
    args = onroad_problem(torch, cfg, dev)
    path_launches = []

    def expect(got, want, n, label):
        want = {fn.__name__: want.get(fn.__name__, 0) * n for fn in ops.KERNELS}
        if got != want:
            fail(f"{label}: launches {got}, expected {want} ({n} solves)")

    # b. mmd_opt, "xla" selection
    solver = FrenetSolver(cfg, device=dev)
    t0 = time.perf_counter()
    check_frenet_solve(solver.solve(0, *args), cfg, "Path D warm-up")
    torch.cuda.synchronize()
    log(f"Path D warm-up solve: {time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    lat = []
    for i in (1, 2):
        ts = time.perf_counter()
        r = solver.solve(i, *args)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - ts)
        check_frenet_solve(r, cfg, "Path D mmd_opt")
    got = {fn.__name__: fn.launches for fn in ops.KERNELS}
    expect(got, {"topk_indices": 2 * n_inner, "eq_qp_solve": n_inner,
                 "fused_rollout": outer}, 2, "Path D mmd_opt xla")
    path_launches.append(got)
    per_solve["path_d_xla"] = {k: v / 2 for k, v in got.items()}
    log(f"Path D (on-road, gaussian 0.1, mmd_opt, xla selection): "
        f"{2 / sum(lat):.2f} solves/s, latencies {[round(1e3 * x, 1) for x in lat]} "
        f"ms; launches per solve {per_solve['path_d_xla']}; last risk_obs "
        f"{float(r.risk_obs):.4f}, v_best[:4] {r.v_best[:4].tolist()}")
    r, summary, _ = traced(lambda: solver.solve(3, *args))
    check_frenet_solve(r, cfg, "Path D traced")
    log(f"Path D mmd_opt xla, one solve under torch.profiler: "
        f"{summary['wall_ms']:.1f} ms wall, device busy "
        f"{summary['device_busy_ms']:.2f} ms, idle share {summary['idle_share']:.3f}, "
        f"{summary['device_events']} device events; top {summary['top'][:5]}")

    # c. the fused selection
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    r, secs, got = counted(torch, ops, "Path D fused", (K3, K2, K1, K4),
                           lambda: solver.solve(4, *args))
    os.environ.pop("MPC_MMD_FUSED_CEM")
    check_frenet_solve(r, cfg, "Path D fused")
    expect(got, {"topk_kernel_matrices": n_inner, "eq_qp_solve": n_inner,
                 "topk_indices": n_inner, "fused_rollout": outer}, 1,
           "Path D fused")
    path_launches.append(got)
    per_solve["path_d_fused"] = dict(got)
    log(f"Path D mmd_opt, fused selection: {1e3 * secs:.1f} ms (first fused "
        f"solve); launches {got}")

    # d. the other modes, one solve each
    for mode in ("cvar", "saa", "mmd_random", "det"):
        cfg_m = cfg.with_risk_mode(mode)
        s = FrenetSolver(cfg_m, device=dev)
        r, secs, got = counted(torch, ops, f"Path D {mode}",
                               () if mode == "det" else (K4,),
                               lambda: s.solve(5, *args))
        check_frenet_solve(r, cfg_m, f"Path D {mode}")
        expect(got, {} if mode == "det" else {"fused_rollout": outer}, 1,
               f"Path D {mode}")
        path_launches.append(got)
        per_solve[f"path_d_{mode}"] = dict(got)
        log(f"Path D {mode}: {1e3 * secs:.1f} ms (first solve), risk_obs "
            f"{float(r.risk_obs):.4f}; launches {got}")

    # e. one outer iteration of mmd_opt, card against CPU, identical draws:
    # those of seed 1, which must agree, and of seed 5, whose inner CEM
    # meets two samples so close in cost that the summation order of the
    # products decides between them (ROADMAP Queue 3): its reading is
    # logged, not held
    cfg1 = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1))
    for seed in (1, 5):
        arrays, _ = record_solve_draws(TorchNoise(torch.Generator(), "cpu"), cfg1, seed)
        out = {}
        for name, device in (("cpu", "cpu"), ("cuda", dev)):
            r = FrenetSolver(cfg1, device=device,
                             noise=FixedNoise(arrays, device)).solve(seed, *args)
            out[name] = [t.cpu() for t in (r.v_best, r.steering_best)]
        err = max(float((g - c).abs().max()) for g, c in zip(out["cuda"], out["cpu"]))
        log(f"Path D cuda vs cpu, one outer iteration of mmd_opt on seed {seed}'s draws: "
            f"v_best and steering_best max diff {err:.3e}"
            + (" (the known near-tie, not held)" if seed == 5 else ""))
        if seed == 1 and not err <= 1e-3:
            fail(f"Path D: the controls differ between cuda and cpu by {err} (> 1e-3)")

    # f. the closed-loop CLI
    for mode, kernels in (("mmd_opt", (K1, K2, K4)), ("cvar", (K4,)), ("det", ())):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            results, secs, got = counted(
                torch, ops, f"Path D closed loop {mode}", kernels,
                lambda: closedloop_cli.main(["--mode", mode, "--route", "curved",
                                             "--episodes", "1", "--max_steps", "20"]))
        episode = json.loads(buf.getvalue().splitlines()[0])
        if not {"collided", "steps", "mean_solve_ms", "p99_solve_ms"} <= set(episode):
            fail(f"Path D closed loop {mode}: no episode line ({buf.getvalue()!r})")
        if mode == "det" and any(got.values()):
            fail(f"Path D closed loop det launched kernels: {got}")
        steps = results[0].steps
        path_launches.append(got)
        per_solve[f"closedloop_{mode}"] = {k: v / steps for k, v in got.items()}
        log(f"Path D closed loop, python -m mpc_mmd_tpu_torch.cli.closedloop --mode "
            f"{mode} --route curved --episodes 1 --max_steps 20: {secs:.2f} s; "
            f"{json.dumps(episode)}; launches {got}")
    return path_launches


def stacked(torch, scenarios):
    """(x, y) obstacle trajectories of ``obstacle_scenarios``, stacked."""
    return (torch.stack([x for x, _ in scenarios]),
            torch.stack([y for _, y in scenarios]))


def check_rows(result, cfg):
    """``check_solve`` on every scenario of a ``solve_batch`` result."""
    for i in range(result.cx.shape[0]):
        check_solve(type(result)(*(f[i] for f in result)), cfg)


def without_sync(torch, fn):
    """``fn()`` with CUDA's sync debug mode at "error": any call that would
    synchronise the host with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def path_e(torch, ops, dev, cfg, cfg_a, cfg_d, work, sweeps, per_solve):
    """Phase 11: scenario chunks and the exact strategy (see the module
    docstring).  ``sweeps`` holds Path C's pipeline sweeps.  Returns the
    launch counts of its runs; adds each run's launches per chunk (per
    solve for a chunk of one or a single solve) to ``per_solve``."""
    from mpc_mmd_tpu_torch import FrenetSolver, Solver
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore

    K1, K2, K3, K4 = (ops.topk_indices, ops.eq_qp_solve, ops.topk_kernel_matrices,
                      ops.fused_rollout)
    names = [fn.__name__ for fn in ops.KERNELS]
    one_solve = {k: round(v) for k, v in per_solve["fastrt"].items()}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    init, mean, cov = f32(INIT), f32(MEAN), f32(COV)
    path_launches = []

    def expect(got, want, label):
        want = {name: want.get(name, 0) for name in names}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")

    def scaled_gap(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    # a. fastrt solve_batch over 8 static scenarios at chunks of 1, 4 and 8
    solvers, results = {}, {}
    for n in (1, 4, 8):
        solvers[n] = solver = Solver(cfg, device=dev, scenario_chunk=n)
        if n == 1:
            xs, ys = stacked(torch, obstacle_scenarios(
                torch, 8, cfg.obstacles.num_obs, solver.ws.tot_time))
        check_rows(solver.solve_batch(list(range(100, 100 + n)), init, mean, cov,
                                      xs[:n], ys[:n], 15.0), cfg)        # warm-up
        held = torch.cuda.memory_allocated()
        r, secs, got = counted(
            torch, ops, f"Path E chunk {n}", (K1, K2, K4),
            lambda: solver.solve_batch(list(range(1, 9)), init, mean, cov, xs, ys,
                                       15.0))
        peak = torch.cuda.max_memory_allocated() - held
        check_rows(r, cfg)
        chunks = 8 // n
        expect(got, {k: chunks * v for k, v in one_solve.items()},
               f"Path E chunk {n} ({chunks} chunks, each one solve's launches)")
        results[n] = r
        per_solve[f"path_e_chunk{n}"] = {k: v / chunks for k, v in got.items()}
        path_launches.append(got)
        log(f"Path E a, fastrt mmd_opt solve_batch over 8 static scenarios at "
            f"scenario_chunk {n}: {8 / secs:.2f} solves/s ({1e3 * secs:.1f} ms), "
            f"peak memory {peak / 2**20:.0f} MiB above the {held / 2**20:.0f} MiB "
            f"held before, launches per chunk "
            f"{per_solve[f'path_e_chunk{n}']} (one solve's: {one_solve})")
    fields = ("cx", "cy", "risk_obs", "res", "mean_param", "cov_param")
    gaps = {n: max(float((getattr(results[n], f) - getattr(results[1], f)).abs().max())
                   for f in fields) for n in (4, 8)}
    log(f"Path E a: the static scenarios at chunks 4 and 8 against chunk 1, largest "
        f"difference in {', '.join(fields)}: {gaps}")
    if any(gaps.values()):
        fail(f"Path E a: a chunk did not give its scenarios the bits of chunk 1: {gaps}")

    # b. each scenario of a chunk of 4 against the same scenario alone, on
    # the tie-free blocking scenarios
    xb, yb = stacked(torch, obstacle_scenarios(
        torch, 4, cfg.obstacles.num_obs, solvers[4].ws.tot_time, blocking=True))
    seeds = [21, 22, 23, 24]
    batch = solvers[4].solve_batch(seeds, init, mean, cov, xb, yb, 15.0)
    worst = {"cx": 0.0, "cy": 0.0, "risk_obs": 0.0}
    for i, seed in enumerate(seeds):
        one = solvers[4].solve(seed, init, mean, cov, xb[i], yb[i], 15.0)
        for name in worst:
            worst[name] = max(worst[name], scaled_gap(getattr(batch, name)[i],
                                                      getattr(one, name)))
    log(f"Path E b, a chunk of 4 blocking scenarios against each solved alone: max "
        f"gap over the scale {worst}")
    if max(worst.values()) > 1e-4:
        fail(f"Path E b: a chunk differs from its scenarios solved alone: {worst}")

    # c. Path A with the fused selection at chunk 4
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cut = dynamic_cutin(cfg_a, 8, device=dev)
    outer_a, n_inner = cfg_a.cem.maxiter_cem, cfg_a.cem.maxiter_cem * cfg_a.beta_cem.maxiter
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    try:
        sa = Solver(cfg_a, device=dev, scenario_chunk=4)
        check_rows(sa.solve_batch([5, 6, 7, 8], init_d, mean_d, cov_d, cut.x_traj[4:],
                                  cut.y_traj[4:], v_des), cfg_a)        # warm-up
        r, secs, got = counted(
            torch, ops, "Path E fused chunk", (K3, K2, K1, K4),
            lambda: sa.solve_batch([1, 2, 3, 4], init_d, mean_d, cov_d,
                                   cut.x_traj[:4], cut.y_traj[:4], v_des))
    finally:
        os.environ.pop("MPC_MMD_FUSED_CEM")
    check_rows(r, cfg_a)
    expect(got, {"topk_kernel_matrices": n_inner, "eq_qp_solve": n_inner,
                 "topk_indices": n_inner, "fused_rollout": outer_a},
           "Path E c, one chunk of 4")
    per_solve["path_e_fused4"] = dict(got)
    path_launches.append(got)
    log(f"Path E c, Path A fused at scenario_chunk 4 (4 cut-in scenarios): "
        f"{4 / secs:.2f} solves/s ({1e3 * secs:.1f} ms a chunk), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches {got}")

    # d. Path B cvar at chunk 4
    sb = Solver(cfg_a.with_risk_mode("cvar"), device=dev, scenario_chunk=4)
    check_rows(sb.solve_batch([5, 6, 7, 8], init_d, mean_d, cov_d, cut.x_traj[4:],
                              cut.y_traj[4:], v_des), cfg_a)            # warm-up
    r, secs, got = counted(
        torch, ops, "Path E cvar chunk", (K4,),
        lambda: sb.solve_batch([1, 2, 3, 4], init_d, mean_d, cov_d, cut.x_traj[:4],
                               cut.y_traj[:4], v_des))
    check_rows(r, cfg_a)
    expect(got, {"fused_rollout": outer_a}, "Path E d, one chunk of 4")
    per_solve["path_e_cvar4"] = dict(got)
    path_launches.append(got)
    log(f"Path E d, Path B cvar at scenario_chunk 4: {4 / secs:.2f} solves/s "
        f"({1e3 * secs:.1f} ms a chunk); launches {got}")

    # e. the sweep CLI with --dispatch batch against Path C's pipeline sweep
    flags = list(SWEEP_FLAGS)
    flags[flags.index("--chunk") + 1] = "8"
    flags[flags.index("--dispatch") + 1] = "batch"
    n_cfg = int(flags[flags.index("--num_configs") + 1])
    n_chunks = sum(-(-min(8, n_cfg - lo) // 4) for lo in range(0, n_cfg, 8))
    data_b = os.path.join(work, "data_batch")
    _, secs_b, got = counted(
        torch, ops, "Path E batch sweep", (K1, K2, K4),
        lambda: sweep_cli.main(["--costs", "mmd_opt", "--out", data_b, *flags,
                                "--scenario_chunk", "4"]))
    expect(got, {k: n_chunks * v for k, v in one_solve.items()},
           f"Path E e, {n_chunks} chunks of 4 scenarios")
    per_solve["sweep_batch_mmd_opt"] = {k: v / n_chunks for k, v in got.items()}
    path_launches.append(got)
    root_p, secs_p = sweeps["mmd_opt"]
    found = glob.glob(os.path.join(data_b, "static", "*", "*", "*", "mmd_opt_*"))
    if len(found) != 1:
        fail(f"Path E e: expected one store, found {found}")
    pipe, bat = ResultStore(root_p).concatenated(), ResultStore(found[0]).concatenated()
    same = np.array_equal(pipe["seeds"], bat["seeds"])
    gap = max((float(np.abs(bat[f] - pipe[f]).max()) / max(1.0, float(np.abs(pipe[f]).max()))
               if same and len(pipe[f]) else 0.0) for f in ("cx", "cy"))
    log(f"Path E e, the sweep CLI over Path C's {n_cfg} static scenarios in mmd_opt: "
        f"--dispatch pipeline {n_cfg / secs_p:.2f} solves/s, --dispatch batch --chunk 8 "
        f"--scenario_chunk 4 {n_cfg / secs_b:.2f} solves/s; accepted {len(pipe['seeds'])} "
        f"and {len(bat['seeds'])}, the same seeds: {same}; cx, cy max gap over "
        f"their scale {gap:.3e}; launches {got}")
    if not same or gap > 1e-4:
        fail("Path E e: the batch dispatch stored other seeds or coefficients than "
             "the pipeline")

    # f. one exact solve of fastrt and of the on-road stack, no host sync
    cfg_x = cfg.replace(solve_strategy="exact")
    sx = Solver(cfg_x, device=dev)
    check_solve(sx.solve(0, init, mean, cov, xs[0], ys[0], 15.0), cfg_x)   # warm-up
    r, secs, got = counted(torch, ops, "Path E exact", (K4,), lambda: without_sync(
        torch, lambda: sx.solve(1, init, mean, cov, xs[1], ys[1], 15.0)))
    check_solve(r, cfg_x)
    expect(got, {"fused_rollout": cfg.cem.maxiter_cem}, "Path E f, fastrt exact")
    per_solve["path_e_exact"] = dict(got)
    path_launches.append(got)
    log(f"Path E f, fastrt mmd_opt exact: {1e3 * secs:.1f} ms a solve under the sync "
        f"debug mode, no host sync; risk_obs {float(r.risk_obs):.4f}; launches {got}")
    cfg_dx = cfg_d.replace(solve_strategy="exact")
    init_o, mean_o, cov_o, *rest = onroad_problem(torch, cfg_dx, dev)
    args = (init_o, f32(mean_o), f32(cov_o), *rest)
    fx = FrenetSolver(cfg_dx, device=dev)
    check_frenet_solve(fx.solve(0, *args), cfg_dx, "Path E exact on-road warm-up")
    r, secs, got = counted(torch, ops, "Path E exact on-road", (K4,),
                           lambda: without_sync(torch, lambda: fx.solve(1, *args)))
    check_frenet_solve(r, cfg_dx, "Path E exact on-road")
    expect(got, {"fused_rollout": cfg_d.cem.maxiter_cem}, "Path E f, on-road exact")
    per_solve["path_d_exact"] = dict(got)
    path_launches.append(got)
    log(f"Path E f, Path D mmd_opt exact FrenetSolver: {1e3 * secs:.1f} ms a solve "
        f"under the sync debug mode, no host sync; risk_obs {float(r.risk_obs):.4f}; "
        f"launches {got}")

    # g. one outer iteration of fastrt exact, card against CPU
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                sx.ws.tot_time.cpu(), blocking=True)[0]
    cuda_vs_cpu(torch, cfg_x.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1)),
                (INIT, MEAN, COV, xo, yo, 15.0), "Path E exact")
    return path_launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import mpc_mmd_tpu_torch
    except ImportError as e:
        fail(f"the package mpc_mmd_tpu_torch is not beside this script ({e})")
    if not os.path.abspath(mpc_mmd_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"imported mpc_mmd_tpu_torch from {mpc_mmd_tpu_torch.__file__}, "
             f"not from {HERE}")
    from mpc_mmd_tpu_torch import (Solver, dynamic_workload, fastrt_workload,
                                   onroad_workload, ops)
    from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
    from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain, topk_onehot_plain
    from mpc_mmd_tpu_torch.ops.topk_kernel import topk_kernel_matrices_plain
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state

    # ---- 1. the card ------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain twins -----------------------------
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50,
                          mode="mmd_opt", noise="gaussian", noise_level=0.1)
    cfg_a = dynamic_workload(num_reduced=10, num_obs=6, noise="beta",
                             noise_level=0.2, num_prime=50, mode="mmd_opt")
    cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50,
                            noise="gaussian", noise_level=0.1)
    k1_at, k2_at = launch_shapes({"fastrt": (cfg, "xla"), "sweep_mmd_opt": (cfg, "xla"),
                                  "path_a_fused": (cfg_a, "fused"),
                                  "path_a_xla": (cfg_a, "xla"),
                                  "path_d_xla": (cfg_d, "xla"),
                                  "path_d_fused": (cfg_d, "fused"),
                                  "closedloop_mmd_opt": (cfg_d, "xla"),
                                  "path_e_chunk1": (cfg, "xla"),
                                  "path_e_chunk4": (cfg, "xla", 4),
                                  "path_e_chunk8": (cfg, "xla", 8),
                                  "sweep_batch_mmd_opt": (cfg, "xla", 4),
                                  "path_e_fused4": (cfg_a, "fused", 4)})
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = check_topk(torch, ops, topk_indices_plain, gen, k1_at)
    log(f"K1 topk_indices: exact at {len(k1_at)} path shapes, edge rows included; "
        f"{k1['ms']:.4f} ms vs plain {k1['plain_ms']:.4f} ms")
    k2 = check_eq_qp(torch, ops, qp_plain, dev, gen, k2_at)
    log(f"K2 eq_qp_solve: max abs err {k2['max_abs_err']:.3e} vs float64 at "
        f"{sorted(k2_at)} systems; {k2['ms']:.4f} ms vs plain {k2['plain_ms']:.4f} ms")
    k4 = check_rollout(torch, ops, rollout_plain, dev, gen,
                       launches_per_solve={"fastrt": 10, "path_e_chunk1": 10,
                                           "path_e_exact": 10})
    # the on-road shapes: 100 candidates x 16 mother rollouts in mmd_opt, x 4
    # rollouts in cvar / saa / mmd_random (400 lanes end in a partial block)
    k4_onroad = []
    for lanes, paths in ((1600, ("path_d_xla", "path_d_fused", "closedloop_mmd_opt",
                                 "path_d_exact")),
                         (400, ("path_d_cvar", "path_d_saa", "path_d_mmd_random",
                                "closedloop_cvar"))):
        k4_onroad.append(check_rollout(
            torch, ops, rollout_plain, dev, gen, lanes=lanes, per_lane=True,
            launches_per_solve={p: cfg_d.cem.maxiter_cem for p in paths}))
        log(f"K4 fused_rollout at the on-road shape ({lanes:,} x 50, a state per "
            f"lane): max abs err {k4_onroad[-1]['max_abs_err']:.3e}; "
            f"{k4_onroad[-1]['ms']:.4f} ms vs plain {k4_onroad[-1]['plain_ms']:.4f} ms")
    # Path E's chunks: fastrt's 4 and 8 scenarios x 64 candidates x 100
    # mother rollouts, Path A's 4 x 100 x 100, Path B cvar's 4 x 100 x 10
    for lanes, paths in ((25_600, {"path_e_chunk4": 10, "sweep_batch_mmd_opt": 10}),
                         (51_200, {"path_e_chunk8": 10}),
                         (40_000, {"path_e_fused4": 20}),
                         (4_000, {"path_e_cvar4": 20})):
        k4_onroad.append(check_rollout(torch, ops, rollout_plain, dev, gen,
                                       lanes=lanes, launches_per_solve=paths))
        log(f"K4 fused_rollout at a chunk's shape ({lanes:,} x 50): max abs err "
            f"{k4_onroad[-1]['max_abs_err']:.3e}; {k4_onroad[-1]['ms']:.4f} ms vs "
            f"plain {k4_onroad[-1]['plain_ms']:.4f} ms")
    k4 = dict(k4, cases=[k4, *k4_onroad],
              max_abs_err=max(c["max_abs_err"] for c in (k4, *k4_onroad)))
    log(f"K4 fused_rollout: max abs err {k4['max_abs_err']:.3e}; "
        f"{k4['ms']:.4f} ms vs plain {k4['plain_ms']:.4f} ms")
    k4v = check_rollout(torch, ops, rollout_plain, dev, gen, lanes=256_000)
    log(f"K4 fused_rollout at the validator's shape (256,000 x 50): max abs err "
        f"{k4v['max_abs_err']:.3e}; {k4v['ms']:.4f} ms vs plain {k4v['plain_ms']:.4f} ms")
    k3 = check_fused_selection(torch, ops, topk_kernel_matrices_plain, dev, gen)
    log(f"K3 topk_kernel_matrices: indices exact, max abs err {k3['max_abs_err']:.3e}; "
        f"{k3['ms']:.4f} ms vs plain {k3['plain_ms']:.4f} ms at (100, 100, 101); "
        f"plain {k3['cases'][1]['plain_ms']:.4f} ms at (100, 100, 17), k=4, "
        f"{k3['cases'][2]['plain_ms']:.4f} ms at (400, 100, 101)")
    k5 = check_topk_onehot(torch, ops, topk_onehot_plain, dev, gen)
    k5_launches = ops.topk_onehot.launches
    log(f"K5 topk_onehot: exact; {k5['ms']:.4f} ms vs plain {k5['plain_ms']:.4f} ms")

    # ---- 3b. each kernel's device time, bound and library yardstick -------
    one = torch.zeros(1, device=dev)
    floor_ms = profiled_ms(torch, lambda: one.fill_(1.0), match="")[0]
    log(f"launch floor: fill_ of one float, {floor_ms:.4f} ms device time")
    for name, rec in (("K1", k1), ("K2", k2), ("K3", k3), ("K4", k4),
                      ("K4", k4v), ("K5", k5)):
        measure(torch, name, rec)

    # ---- 4. the full-width fastrt solve -----------------------------------
    t0 = time.perf_counter()
    solver = Solver(cfg, device=dev)
    scen = obstacle_scenarios(torch, 4, cfg.obstacles.num_obs, solver.ws.tot_time)
    r = solver.solve(0, INIT, MEAN, COV, *scen[0], 15.0)
    torch.cuda.synchronize()
    log(f"fastrt warm-up solve: {time.perf_counter() - t0:.2f} s")
    check_solve(r, cfg)
    path_launches = [timed_solves(
        torch, ops, solver, cfg,
        [(i, (INIT, MEAN, COV, *scen[i], 15.0)) for i in range(1, 4)],
        "fastrt (static, gaussian 0.1, xla selection)",
        (ops.topk_indices, ops.eq_qp_solve, ops.fused_rollout))]
    per_solve = {"fastrt": {k: v / 3 for k, v in path_launches[-1].items()}}

    # ---- 5. one outer iteration, card against CPU -------------------------
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                solver.ws.tot_time.cpu(), blocking=True)[0]
    cuda_vs_cpu(torch, cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1)),
                (INIT, MEAN, COV, xo, yo, 15.0), "fastrt")

    # ---- 6. Path A: dynamic cut-in, fused selection -----------------------
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cutin = dynamic_cutin(cfg_a, 3, device=dev)
    xs, ys = cutin.x_traj, cutin.y_traj
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    t0 = time.perf_counter()
    solver_a = Solver(cfg_a, device=dev)
    check_solve(solver_a.solve(0, init_d, mean_d, cov_d, xs[0], ys[0], v_des), cfg_a)
    torch.cuda.synchronize()
    log(f"Path A warm-up solve: {time.perf_counter() - t0:.2f} s")
    calls_a = [(i, (init_d, mean_d, cov_d, xs[i], ys[i], v_des)) for i in (1, 2)]
    got = timed_solves(torch, ops, solver_a, cfg_a, calls_a,
                       "Path A (dynamic cut-in, beta 0.2, mmd_opt, fused selection)",
                       (ops.topk_kernel_matrices, ops.eq_qp_solve,
                        ops.topk_indices, ops.fused_rollout))
    n_inner = cfg_a.cem.maxiter_cem * cfg_a.beta_cem.maxiter
    want = {"topk_kernel_matrices": n_inner, "eq_qp_solve": n_inner,
            "topk_indices": n_inner, "fused_rollout": cfg_a.cem.maxiter_cem,
            "topk_onehot": 0}
    want = {k: v * len(calls_a) for k, v in want.items()}
    if got != want:
        fail(f"Path A launches {got}, expected {want} ({len(calls_a)} solves)")
    path_launches.append(got)
    per_solve["path_a_fused"] = {k: v / len(calls_a) for k, v in got.items()}
    trace_path_a(torch, ops, solver_a, cfg_a, calls_a[0])
    os.environ.pop("MPC_MMD_FUSED_CEM")
    check_solve(solver_a.solve(0, init_d, mean_d, cov_d, xs[0], ys[0], v_des), cfg_a)
    path_launches.append(timed_solves(
        torch, ops, solver_a, cfg_a, calls_a,
        "Path A (dynamic cut-in, beta 0.2, mmd_opt, xla selection)",
        (ops.topk_indices, ops.eq_qp_solve, ops.fused_rollout)))
    per_solve["path_a_xla"] = {k: v / len(calls_a)
                               for k, v in path_launches[-1].items()}

    # ---- 7. Path B: the same workload in cvar, mmd_random, saa -------------
    for mode, warm, n in (("cvar", True, 2), ("mmd_random", False, 1),
                          ("saa", False, 1)):
        cfg_b = cfg_a.with_risk_mode(mode)
        solver_b = Solver(cfg_b, device=dev)
        if warm:
            check_solve(solver_b.solve(0, init_d, mean_d, cov_d, xs[0], ys[0],
                                       v_des), cfg_b)
        path_launches.append(timed_solves(
            torch, ops, solver_b, cfg_b, calls_a[:n],
            f"Path B (dynamic cut-in, beta 0.2, {mode})", (ops.fused_rollout,)))
        per_solve[f"path_b_{mode}"] = {k: v / n for k, v in path_launches[-1].items()}

    # ---- 8. Path A, one outer iteration, card against CPU -----------------
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    cuda_vs_cpu(torch, cfg_a.replace(cem=dataclasses.replace(cfg_a.cem, maxiter_cem=1)),
                (init_d, mean_d, cov_d, xs[0].cpu(), ys[0].cpu(), v_des), "Path A")
    os.environ.pop("MPC_MMD_FUSED_CEM")

    # ---- 9. Path C: sweep -> validation pipeline ---------------------------
    # ---- 11e runs in Path C's directory, against its pipeline sweep --------
    with tempfile.TemporaryDirectory() as work:
        launches_c, sweeps = path_c(torch, ops, dev, work, per_solve)
        path_launches += launches_c

        # ---- 10. Path D: the on-road stack ---------------------------------
        path_launches += path_d(torch, ops, dev, cfg_d, per_solve)

        # ---- 11. Path E: scenario chunks and the exact strategy ------------
        path_launches += path_e(torch, ops, dev, cfg, cfg_a, cfg_d, work, sweeps,
                                per_solve)

    # ---- records ----------------------------------------------------------
    launches = {fn.__name__: sum(p[fn.__name__] for p in path_launches)
                for fn in ops.KERNELS}
    launches["topk_onehot"] = k5_launches
    checked = lambda rec: {c["shape"]: c["launches_per_solve"]
                           for c in rec["cases"] if c["launches_per_solve"]}
    check_launch_shapes({"topk_indices": k1_at, "eq_qp_solve": k2_at,
                         "topk_kernel_matrices": checked(k3),
                         "fused_rollout": checked(k4)}, per_solve)
    record = kernel_record(ops, launches, per_solve, floor_ms, k1, k2, k3, (k4, k4v), k5)
    log(json.dumps({"kernels": record}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
