#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. the card: name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``mpc_mmd_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, at the shapes of
   the full-width fastrt solve, with CUDA-event times of both:
   K1 top-k indices equal exactly (rows with NaNs and ties included),
   K2 QP within rtol 1e-4 + atol 1e-5 of the twin run in float64,
   K4 rollout within atol 1e-4;
4. the full-width fastrt ``mmd_opt`` solve (64 candidates x 10 iterations,
   100 mother rollouts, inner CEM 64 samples x 12 iterations): one warm-up
   solve, then 3 scenarios, each with finite coefficients and risk and
   sum(beta) = 1 within 1e-3, with every kernel's launch count above 0;
5. one outer iteration on the card against the same on the CPU with
   identical draws: the controls of the returned coefficients within 1e-3
   (the JAX package's parity bar) and the coefficients within 1e-3 of
   their scale.

Prints the kernels' JSON record and the card's nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when there is no CUDA card or the package is not beside it.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
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


def check_topk(torch, ops, topk_plain, dev, gen):
    """K1 at the selection shape (C, S - n_el, M + 1), the iteration-0 shape
    and the elite pick (-cost over (C, S))."""
    x = torch.randn(64, 57, 101, device=dev, generator=gen)
    x[0, 0] = float("nan")                        # all-NaN row
    x[0, 1, ::3] = float("nan")                   # NaN lanes
    x[1] = torch.round(x[1] * 2) / 2              # ties in every row
    x0 = torch.randn(1, 64, 101, device=dev, generator=gen)
    cost = torch.randn(64, 64, device=dev, generator=gen)
    cost[3, 5] = float("inf")
    cost[4] = torch.round(cost[4])
    cases = [(x, 10, dict(absolute=True, slice_to=100)),
             (x0, 10, dict(absolute=True, slice_to=100)),
             (-cost, 7, {})]
    err = 0
    for t, k, kw in cases:
        got = ops.topk_indices(t, k, **kw)
        ref = topk_plain(t, k, **kw)
        torch.cuda.synchronize()
        err = max(err, int((got.long() - ref.long()).abs().max()))
    if err != 0:
        fail(f"K1 topk_indices disagrees with its plain twin (max index diff {err})")
    ms = cuda_ms(torch, lambda: ops.topk_indices(x, 10, absolute=True, slice_to=100))
    plain = cuda_ms(torch, lambda: topk_plain(x, 10, absolute=True, slice_to=100))
    return err, ms, plain


def check_eq_qp(torch, ops, qp_plain, dev, gen):
    """K2 on (64, 57, 10, 10) systems built as the inner CEM builds them:
    rho K + reg I with K a Laplace kernel matrix, r = rho/M row sums."""
    f = torch.randn(64, 57, 10, 22, device=dev, generator=gen)
    d = (f[..., :, None, :] - f[..., None, :, :]).abs().sum(-1)
    sigma = torch.randn(64, 57, 1, 1, device=dev, generator=gen).abs() * 4.5 + 0.01
    K = torch.exp(-d / sigma)
    C = (K + 0.05 * torch.eye(10, device=dev)).contiguous()
    r = (K.sum(-1) / 100.0).contiguous()
    b, mu = ops.eq_qp_solve(C, r)
    b64, mu64 = qp_plain(C.double(), r.double())
    torch.cuda.synchronize()
    for name, got, ref in (("b", b, b64), ("mu", mu, mu64)):
        bad = (got.double() - ref).abs() > 1e-4 * ref.abs() + 1e-5
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            fail(f"K2 eq_qp_solve {name} outside rtol 1e-4 + atol 1e-5 of the "
                 f"float64 twin at {int(bad.sum())} entries")
    err = max(float((b.double() - b64).abs().max()),
              float((mu.double() - mu64).abs().max()))
    ms = cuda_ms(torch, lambda: ops.eq_qp_solve(C, r))
    plain = cuda_ms(torch, lambda: qp_plain(C, r), reps=10)
    return err, ms, plain


def check_rollout(torch, ops, rollout_plain, dev, gen):
    """K4 on 6400 lanes x 50 steps from one shared initial state."""
    acc = (1.0 + 0.5 * torch.randn(6400, 50, device=dev, generator=gen)).contiguous()
    steer = (0.1 * torch.randn(6400, 50, device=dev, generator=gen)).contiguous()
    s0 = torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device=dev)
    args = (acc, steer, s0, 0.15, 2.5)
    x, y = ops.fused_rollout(*args)
    xr, yr = rollout_plain(*args)
    torch.cuda.synchronize()
    err = max(float((x - xr).abs().max()), float((y - yr).abs().max()))
    if not err <= 1e-4:
        fail(f"K4 fused_rollout differs from its plain twin by {err} (> 1e-4)")
    ms = cuda_ms(torch, lambda: ops.fused_rollout(*args))
    plain = cuda_ms(torch, lambda: rollout_plain(*args), reps=10)
    return err, ms, plain


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


def controls(ws, cfg, cx, cy):
    from mpc_mmd_tpu_torch.dynamics import controls_from_trajectory
    T = cfg.horizon.num_prime
    a, s = controls_from_trajectory((ws.Pdot @ cx)[None], (ws.Pdot @ cy)[None],
                                    (ws.Pddot @ cx)[None], (ws.Pddot @ cy)[None],
                                    cfg.horizon.dt, cfg.vehicle.wheel_base)
    return a[0, :T], s[0, :T]


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
    from mpc_mmd_tpu_torch import Solver, fastrt_workload, ops
    from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
    from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
    from mpc_mmd_tpu_torch.noise import FixedNoise, TorchNoise
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain

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
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = check_topk(torch, ops, topk_indices_plain, dev, gen)
    log(f"K1 topk_indices: exact; {k1[1]:.4f} ms vs plain {k1[2]:.4f} ms")
    k2 = check_eq_qp(torch, ops, qp_plain, dev, gen)
    log(f"K2 eq_qp_solve: max abs err {k2[0]:.3e} vs float64; "
        f"{k2[1]:.4f} ms vs plain {k2[2]:.4f} ms")
    k4 = check_rollout(torch, ops, rollout_plain, dev, gen)
    log(f"K4 fused_rollout: max abs err {k4[0]:.3e}; "
        f"{k4[1]:.4f} ms vs plain {k4[2]:.4f} ms")

    # ---- 4. the full-width solve ------------------------------------------
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50,
                          mode="mmd_opt", noise="gaussian", noise_level=0.1)
    t0 = time.perf_counter()
    solver = Solver(cfg, device=dev)
    scen = obstacle_scenarios(torch, 4, cfg.obstacles.num_obs, solver.ws.tot_time)
    r = solver.solve(0, INIT, MEAN, COV, *scen[0], 15.0)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    check_solve(r, cfg)

    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    t0 = time.perf_counter()
    for i in range(1, 4):
        ts = time.perf_counter()
        r = solver.solve(i, INIT, MEAN, COV, *scen[i], 15.0)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - ts)
        check_solve(r, cfg)
    solves_per_s = 3 / (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    log(f"solve: warm-up {warmup_s:.2f} s, {solves_per_s:.2f} solves/s, "
        f"latencies {[round(1e3 * x, 1) for x in lat]} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB on {smi}; "
        f"launches {launches}; last risk_obs {float(r.risk_obs):.4f}")

    # ---- 5. one outer iteration, card against CPU -------------------------
    cfg1 = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1))
    c, bc = cfg1.cem, cfg1.beta_cem
    src = TorchNoise(torch.Generator(), "cpu")
    R, T, M = cfg1.risk.num_reduced, cfg1.horizon.num_prime, cfg1.risk.num_mother
    inner = src.inner_cem(bc.num_samples_cem, M, bc.num_ellite, bc.maxiter)
    eps = src.rollout_eps(5, 0, R, T)
    arrays = {"initial_z": src.initial_z(c.num_batch, c.num_params),
              "samples0": inner.samples0, "u": inner.u, "z": inner.z,
              "eps_acc": eps[0][None], "eps_steer": eps[1][None],
              "eps_const": eps[2][None],
              "cem_z": src.cem_z(5, 0, c.num_batch - c.ellite_num,
                                 c.num_params)[None]}
    arrays = {k: v.numpy() for k, v in arrays.items()}
    xo, yo = obstacle_scenarios(torch, 1, cfg1.obstacles.num_obs,
                                solver.ws.tot_time.cpu(), blocking=True)[0]
    out = {}
    for name in ("cuda", "cpu"):
        s = Solver(cfg1, device=name, noise=FixedNoise(arrays, name))
        res = s.solve(5, INIT, MEAN, COV, xo, yo, 15.0)
        out[name] = (s.ws, [t.cpu() for t in (res.cx, res.cy)],
                     float(res.risk_obs))
    ws_cpu = out["cpu"][0]
    (cxg, cyg), (cxc, cyc) = out["cuda"][1], out["cpu"][1]
    ag, sg = controls(ws_cpu, cfg1, cxg, cyg)
    ac, sc = controls(ws_cpu, cfg1, cxc, cyc)
    ctrl_err = max(float((ag - ac).abs().max()), float((sg - sc).abs().max()))
    scale = max(1.0, float(cxc.abs().max()), float(cyc.abs().max()))
    coef_err = max(float((cxg - cxc).abs().max()), float((cyg - cyc).abs().max()))
    log(f"cuda vs cpu, one outer iteration: controls max diff {ctrl_err:.3e}, "
        f"coefficients max diff {coef_err:.3e} (scale {scale:.1f}), risk_obs "
        f"{out['cuda'][2]:.6f} vs {out['cpu'][2]:.6f}")
    if not ctrl_err <= 1e-3:
        fail(f"controls differ between cuda and cpu by {ctrl_err} (> 1e-3)")
    if not coef_err <= 1e-3 * scale:
        fail(f"coefficients differ between cuda and cpu by {coef_err} "
             f"(> 1e-3 x {scale})")

    # ---- records ----------------------------------------------------------
    record = []
    for fn, src_file, tpu, (err, ms, plain_ms) in (
            (ops.topk_indices, "topk.cu", "mpc_mmd_tpu/ops/topk_pallas.py:116", k1),
            (ops.eq_qp_solve, "eq_qp.cu", "mpc_mmd_tpu/ops/qp_pallas.py:109", k2),
            (ops.fused_rollout, "rollout.cu",
             "mpc_mmd_tpu/ops/rollout_pallas.py:101", k4)):
        record.append({"name": fn.__name__, "route": "cuda",
                       "source": f"mpc_mmd_tpu_torch/csrc/{src_file}",
                       "replaces": tpu, "launches": launches[fn.__name__],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    log(json.dumps({"kernels": record}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
