"""K1, K2 and K5 built from several sources, checked and timed in turns.

    python -m mpc_mmd_tpu_torch.utils.kernel_ab --before DIR [--diagnose] [--out DIR]

``--before DIR`` names a directory that holds an earlier version's
``topk.cu`` and ``eq_qp.cu``, for example from ``git show
<commit>:mpc_mmd_tpu_torch/csrc/topk.cu > DIR/topk.cu``.  Each build below
is compiled with the flags of ``ops/_build.py`` into its own shared library
under ``build/kernel_ab/`` (one ``nvcc`` per build, all started together)
and loaded with ``ctypes``; their C symbols do not clash.

Builds: ``now`` (the sources in ``csrc/``), ``before`` (DIR), and variants
of the current sources, each one textual change:
``k1_rows1`` / ``k1_rows2`` (K1 with one or two rows per warp whatever the
row count), ``k2_threads32`` (K2 with one warp a block); with
``--diagnose`` also ``k1_no_rounds`` (K1 loads, sorts and stores each
lane's head, no round),
``k2_no_copies`` (K2 without its cp.async staging) and ``k2_no_math`` (K2
without its factorisation), whose outputs are meaningless, and a
microbenchmark of the latency of one ``redux.sync`` and one
``shfl.sync`` step (clock64 over a dependent chain of 256).

On the card, the checks: every K1 build but ``k1_no_rounds`` equals the
plain twin exactly at K1's path shapes, with an all-NaN row, NaN lanes,
ties, -0.0 against +0.0, +-inf and fewer finite lanes than k; every K2
build but the diagnostic ones is within rtol 1e-4 + atol 1e-5 of the
float64 twin at K2's path sizes, and whether ``now`` is bit-equal to
``before`` is recorded, also on a view at an odd system offset; K5 of
``now`` against ``before``.  Then the times: each build's device time per
launch from ``torch.profiler`` (20 launches, 3 windows), the builds of a
shape in turns (the order reversed every other window), beside the launch
floor (``fill_`` of one float) and ``torch.topk``.  Writes
``kernel_ab.json`` and ``kernel_ab.txt`` to ``--out`` (default
``build/kernel_ab/``).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from ..linalg import eq_qp_solve as qp_plain
from ..ops import _build
from ..ops.topk import topk_indices_plain

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "build" / "kernel_ab"

# K1's path shapes (shape, k, absolute, ranked width m) and K2's sizes, as
# chip_smoke.py's launch_shapes gives them
K1_SHAPES = (((64, 57, 101), 10, True, 100), ((1, 64, 101), 10, True, 100),
             ((64, 64), 7, False, 64), ((100, 89, 101), 10, True, 100),
             ((1, 100, 101), 10, True, 100), ((100, 100), 11, False, 100))
K2_SIZES = (3648, 4096, 8900, 10000)

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


def _replace(src: str, old: str, new: str, name: str) -> str:
    if old not in src:
        raise ValueError(f"variant {name}: its anchor is not in the source")
    return src.replace(old, new)


def _between(src: str, start: str, end: str, name: str):
    """(head, middle, tail) of src cut at the first ``start`` and the
    following ``end``."""
    a = src.find(start)
    b = src.find(end, a)
    if a < 0 or b < 0:
        raise ValueError(f"variant {name}: its anchors are not in the source")
    return src[:a], src[a:b], src[b:]


def builds(before: Path, diagnose: bool = False) -> dict:
    """name -> (kind, CUDA source); kind is "k1" (topk.cu), "k2" (eq_qp.cu)
    or "micro"."""
    topk = (_build.CSRC / "topk.cu").read_text()
    qp = (_build.CSRC / "eq_qp.cu").read_text()
    out = {"k1_now": ("k1", topk), "k1_before": ("k1", (before / "topk.cu").read_text()),
           "k2_now": ("k2", qp), "k2_before": ("k2", (before / "eq_qp.cu").read_text())}
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
        head, _, tail = _between(qp, "    float inv_diag[N];", "    float bv[N];", "k2_no_math")
        out["k2_no_math"] = ("k2", head + (
            "    float z[N], w[N];\n#pragma unroll\n"
            "    for (int i = 0; i < N; ++i) { z[i] = rv[i] + a[i][i]; w[i] = 0.0f; }\n"
            "    const float m = 0.0f;\n") + tail)
        out["micro"] = ("micro", MICRO)
    return out


def build_all(sources: dict, log) -> dict:
    """Compiles every source at once; name -> loaded library."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (_, src) in sources.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(src)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(so),
               str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, (so, proc) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        log(f"built {name}: registers {re.findall(r'Used (\d+) registers', text)}, stack "
            f"frames {re.findall(r'(\d+) bytes stack frame', text)}")
        lib = ctypes.CDLL(str(so))
        kind = sources[name][0]
        if kind == "micro":
            lib.micro.argtypes = [P, ctypes.c_uint, P]
        elif kind == "k1":
            lib.mmd_topk_indices.argtypes = [P, P, I, I, I, I, I, P]
            lib.mmd_topk_onehot.argtypes = [P, P, P, I, I, I, I, I, P]
        else:
            lib.mmd_eq_qp_solve.argtypes = [P, P, P, P, I, I, P]
        libs[name] = lib
    return libs


def device_ms(fn, match: str, reps: int = 20) -> float:
    """Device milliseconds per call: the device events whose name holds
    ``match`` in a profiled window of ``reps`` calls, which must number at
    least ``reps`` (a library call may launch several kernels)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device event
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if len(ev) >= reps:
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps
    raise RuntimeError(f"profiler: {len(ev)} device events named {match!r} for {reps} calls")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _call(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def k1_inputs(gen, shape, k, absolute):
    """Random rows with the edge rows of the module docstring; the elite
    pick's rows are -cost."""
    x = torch.randn(shape, device="cuda", generator=gen)
    flat = x.view(-1, shape[-1])
    flat[0] = float("nan")
    flat[1, ::3] = float("nan")
    flat[2] = torch.round(flat[2] * 2) / 2
    flat[3] = 0.0
    flat[3, ::2] = -0.0
    flat[4, 5], flat[4, 7] = float("inf"), -float("inf")
    flat[5, :shape[-1] - k + 2] = float("nan")
    return x if absolute else -x


def k2_inputs(gen, batch, n=10):
    """Systems as the inner CEM builds them (rho K + reg I, Laplace K)."""
    f = torch.randn(batch, n, 22, device="cuda", generator=gen)
    d = (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1)
    sigma = torch.rand(batch, 1, 1, device="cuda", generator=gen) * 10 + 0.01
    K = torch.exp(-d / sigma)
    return ((K + 0.05 * torch.eye(n, device="cuda")).contiguous(),
            (K.sum(-1) / 100.0).contiguous())


def _k1(lib, x, k, absolute, m, out):
    w = x.shape[-1]
    _call(lib.mmd_topk_indices(x.data_ptr(), out.data_ptr(), x.numel() // w, w, m, k,
                               int(absolute), _stream()), "mmd_topk_indices")


def _k2(lib, C, r, b, mu):
    n = C.shape[-1]
    _call(lib.mmd_eq_qp_solve(C.data_ptr(), r.data_ptr(), b.data_ptr(), mu.data_ptr(),
                              r.numel() // n, n, _stream()), "mmd_eq_qp_solve")


def in_turns(fns: dict, match: str, windows: int = 3) -> dict:
    """name -> device ms of each window, the names timed in turns."""
    times = {name: [] for name in fns}
    for w in range(windows):
        for name in (list(fns) if w % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name], match))
    return times


def run(before: Path, out: Path, diagnose: bool = False) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    lines = []

    def log(msg):
        print(msg, flush=True)
        lines.append(msg)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(f"card: {smi.stdout.strip()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = builds(before, diagnose)
    t0 = time.perf_counter()
    libs = build_all(sources, log)
    log(f"{len(libs)} builds in {time.perf_counter() - t0:.1f} s")
    k1s = [n for n, (kind, _) in sources.items() if kind == "k1"]
    k2s = [n for n, (kind, _) in sources.items() if kind == "k2"]
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
    for shape, k, absolute, m in K1_SHAPES:
        x = k1_inputs(gen, shape, k, absolute)
        ref = topk_indices_plain(x, k, absolute, m if m < shape[-1] else None)
        idx = torch.empty(shape[:-1] + (k,), dtype=torch.int32, device="cuda")
        for name in exact_k1:
            idx.fill_(-1)
            _k1(libs[name], x, k, absolute, m, idx)
            torch.cuda.synchronize()
            if not torch.equal(idx, ref):
                raise RuntimeError(f"{name} differs from the twin at {shape}, k={k}")
        ranked = (x[..., :m].abs() if absolute else x).contiguous()
        times = in_turns({n: (lambda n=n: _k1(libs[n], x, k, absolute, m, idx)) for n in k1s},
                         "topk")
        lib_ms = device_ms(lambda: torch.topk(ranked, k, dim=-1), "")
        rec["k1"].append({"shape": list(shape), "k": k, "absolute": absolute, "m": m,
                          "device_ms": times, "torch_topk_ms": lib_ms})
        log(f"K1 {shape} k={k}: equal to the twin in {len(exact_k1)} builds; device us "
            + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}" for n, ts in times.items())
            + f"; torch.topk {1e3 * lib_ms:.3f}")

    rec["k2"] = []
    for batch in K2_SIZES:
        C, r = k2_inputs(gen, batch)
        b64, mu64 = qp_plain(C.double(), r.double())
        got = {}
        for name in exact_k2:
            b = torch.full_like(r, float("nan"))
            mu = torch.full((batch,), float("nan"), device="cuda")
            _k2(libs[name], C, r, b, mu)
            torch.cuda.synchronize()
            for t, t64 in ((b, b64), (mu, mu64)):
                if not bool(((t.double() - t64).abs() <= 1e-4 * t64.abs() + 1e-5).all()):
                    raise RuntimeError(f"{name} outside rtol 1e-4 + atol 1e-5 at {batch}")
            got[name] = (b, mu)
        equal = all(torch.equal(a, c) for a, c in zip(got["k2_now"], got["k2_before"]))
        b, mu = torch.empty_like(r), torch.empty(batch, device="cuda")
        times = in_turns({n: (lambda n=n: _k2(libs[n], C, r, b, mu)) for n in k2s}, "eq_qp")
        rec["k2"].append({"systems": batch, "bit_equal_to_before": equal, "device_ms": times})
        log(f"K2 {batch} systems: now bit-equal to before {equal}; device us "
            + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}" for n, ts in times.items()))
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
    rec["k5"] = {"shape": [64, 57, 101], "k": 10, "device_ms": times,
                 "equal_to_before": all(torch.equal(a, c) for a, c in zip(*outs))}
    log(f"K5 (64, 57, 101) k=10: now equal to before {rec['k5']['equal_to_before']}; "
        "device us " + ", ".join(f"{n} {[round(1e3 * t, 3) for t in ts]}"
                                 for n, ts in times.items()))
    (out / "kernel_ab.json").write_text(json.dumps(rec, indent=1))
    (out / "kernel_ab.txt").write_text("\n".join(lines) + "\n")
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--before", type=Path, required=True,
                   help="directory with an earlier topk.cu and eq_qp.cu")
    p.add_argument("--diagnose", action="store_true",
                   help="also the diagnostic builds and the latency microbenchmark")
    p.add_argument("--out", type=Path, default=OUT_DIR)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    run(args.before, args.out, args.diagnose)


if __name__ == "__main__":
    main()
