"""Build and load the port's CUDA kernels (``csrc/*.cu``) as one library.

``nvcc`` compiles every source of ``csrc/`` for ``sm_90a`` into one shared
library with a plain C interface, which is loaded with ``ctypes``.  The
build happens at first use, under ``build/torch_kernels/`` at the root of
the checkout, and is keyed on a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is loaded as it is.  No fast-math: the
rollout kernel chains ``tanf``/``sinf``/``cosf`` over 50 steps, and its
tolerance assumes the IEEE-accurate functions.

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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes of the C entry points (pointers and the stream as void*)
_SIGNATURES = {
    "mmd_topk_indices": [_P, _P, _I, _I, _I, _I, _I, _P],
    "mmd_eq_qp_solve": [_P, _P, _P, _P, _I, _I, _P],
    "mmd_fused_rollout": [_P, _P, _P, _I, _P, _P, _I, _I, _F, _F, _P],
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / (target.stem + ".log")).write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
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
