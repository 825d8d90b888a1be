"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

``nvcc`` compiles every source of ``csrc/`` for ``sm_90a``, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
build happens at first use, under ``build/torch_kernels/`` at the root of
the checkout, and is keyed on a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is loaded as it is.  No fast-math: the
rollout kernel chains ``tanf``/``sinf``/``cosf`` over 50 steps, and its
tolerance assumes the IEEE-accurate functions; the random-number kernels
(``prng.cu``) must call the same ``logf``/``log1pf``/``expf`` as PyTorch's
own kernels to give their twins' bits, and kernels (c) to (g)
(``inner_cem.cu`` and ``inner_cem_fused.cu``, ``outer_project.cu``, ``outer_tail.cu``,
``inner_prologue.cu``, ``frenet_points.cu``) and (h) (``local_frame.cu``)
the quotients, transcendental functions, sums and products of PyTorch's,
cuBLAS's and CUB's kernels to give their plain versions'.

Each exported function returns its ``cudaError_t``; :func:`check` raises if
it is not 0.  Kernels launch on PyTorch's current stream and allocate
nothing: the wrappers in ``ops/`` allocate outputs with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes of the C entry points (pointers and the stream as void*)
_SIGNATURES = {
    "mmd_topk_indices": [_P, _P, _I, _I, _I, _I, _I, _P],
    "mmd_topk_onehot": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mmd_topk_kernel_matrices": [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mmd_eq_qp_solve": [_P, _P, _P, _P, _I, _I, _P],
    "mmd_eq_qp_solve_t": [_P, _P, _P, _P, _I, _I, _P],
    "mmd_fused_rollout": [_P, _P, _P, _I, _P, _P, _I, _I, _F, _F, _P],
    "mmd_noisy_rollout": [_P] * 6 + [_I, _P, _P] + [_I] * 7 + [_F] * 4 + [_I, _F, _F, _P],
    "mmd_inner_prologue": [_P] * 8 + [_I] * 5 + [_P],
    "mmd_frenet_points": [_P] * 11 + [_I, _I, _F, _P],
    "mmd_frenet_obstacles": [_P] * 12 + [_I, _I, _I, _F, _P],
    "mmd_frenet_states": [_P] * 13 + [_I, _I, _I] + [_F] * 6 + [_P],
    "mmd_prng_draws": [_P, _L, _L, _I, _P, _P],
    "mmd_prng_beta": [_P, _P, _P, _L, _L, _L, _L, _P, _P],
    "mmd_inner_cem": [_P] * 11 + [_I] * 7 + [_F] * 4 + [_I, _I, _L, _P],
    "mmd_inner_cem_scratch": [_I] * 7,
    "mmd_inner_cem_last_cluster": [],
    "mmd_outer_project": ([_P] * 34 + [_I] * 6 + [_F] * 10 + [_I] * 2 + [_P, _P, _I, _I]
                          + [_F] * 6 + [_P]),
    "mmd_outer_tail": [_P] * 32 + [_I] * 16 + [_F] * 23 + [_I, _I, _F, _I, _I, _F, _F, _P],
    "mmd_outer_tail_cluster": [_I],
    "mmd_outer_tail_last_cluster": [],
    "mmd_local_frame": [_P] * 4 + [_I, _I, _F, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _digest() -> str:
    """Hash of the flags and of every source and header in ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless a build of these sources exists; its path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"libmpc_mmd_kernels_{_digest()}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        lib = Path(tmp) / "lib.so"
        compiles = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources, objs)]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib), *map(str, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        runs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in zip(compiles, procs)]
        if all(rc == 0 for _, _, rc in runs):
            done = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            runs.append((link, done.stdout, done.returncode))
        text = "".join(" ".join(cmd) + "\n" + out for cmd, out, _ in runs)
        (BUILD_DIR / (target.stem + ".log")).write_text(text)
        if any(rc != 0 for _, _, rc in runs) or not lib.exists():
            raise RuntimeError(f"nvcc failed:\n{text}")
        os.replace(lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_log() -> str:
    """nvcc's output for the current sources (registers, spills), if built."""
    path = BUILD_DIR / f"libmpc_mmd_kernels_{_digest()}.log"
    return path.read_text() if path.exists() else ""


def stream() -> int:
    """PyTorch's current CUDA stream as an integer handle."""
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def require_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous float32 on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensors on {t.device}, but the "
                             f"current device is {torch.cuda.current_device()}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
