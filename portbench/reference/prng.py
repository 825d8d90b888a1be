# Frozen copy of mpc_mmd_tpu_torch/prng.py (commit eb91b04) cut to the
# Gaussian draws: every hand-written kernel call taken out, so this runs
# PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""The JAX package's random numbers, in plain PyTorch: its Gaussian draws.

A copy of ``jax.random``'s threefry-2x32 key chain as far as the cells'
draws use it, jax 0.9 under ``jax_threefry_partitionable`` (the default
since jax 0.5) and 32-bit integers (``jax_enable_x64`` off):

* a key is a pair of uint32 words held in an int64 tensor (..., 2) and
  masked to 32 bits; a batch of keys carries leading axes;
* :func:`threefry2x32` is the 20-round hash (rotations 13, 15, 26, 6 and
  17, 29, 16, 24; key schedule with 0x1BD11BDA), on Python ints or int64
  tensors alike (jax/_src/prng.py:1092); :func:`random_bits` the
  partitionable bits, ``out1 ^ out2`` of the hash of the element's 64-bit
  flat index (prng.py:989,1184);
* uniforms on [nextafter(-1, 0), 1), then normals as sqrt(2) erfinv with
  the float32 polynomial ``lax.erf_inv`` lowers to
  (jax/_src/random.py).

Bits and uniforms equal JAX's exactly.  XLA contracts a multiply and an
add into one rounding (:func:`fma`) in the uniforms' affine map and the
erfinv polynomial, and so does this copy.  Normals go through ``log1p``,
whose float32 results differ from XLA's by an ulp now and then, so they
agree within a few ulp.

:func:`draws` and :func:`plan` are the plain twins of the port's draw
kernels (``ops/prng.py``): a batch of keys to bits, uniforms or normals,
and several such batches (a solve's draws) into one buffer.  The Beta,
gamma, choice and permutation draws are the port's.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))
# lax.erf_inv's float32 polynomial (XLA's ErfInv32, Giles' approximation):
# coefficients for w = -log1p(-x^2) < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

Word = Union[int, torch.Tensor]
Shape = Union[int, Sequence[int]]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The threefry-2x32 hash of counter words (x0, x1) under key words
    (k0, k1): two output words.  Python ints or int64 tensors holding
    uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(shape)


def _hash_iota(keys: torch.Tensor, shape: Shape):
    """The hash of every flat index of ``shape`` (64-bit, as (hi, lo) words)
    under each key of ``keys`` (..., 2): two words (..., *shape)."""
    shape = _shape(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    at = tuple(keys.shape[:-1]) + (1,) * len(shape)
    k0 = keys[..., 0].reshape(at)
    k1 = keys[..., 1].reshape(at)
    y0, y1 = threefry2x32(k0, k1, (i >> 32).view(shape), (i & M32).view(shape))
    return y0, y1


def split_int(k: Tuple[int, int], num: int = 2) -> Tuple[Tuple[int, int], ...]:
    """:func:`split` of one key held as two Python ints (no tensor work)."""
    return tuple(threefry2x32(k[0], k[1], 0, i) for i in range(num))


def random_bits(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element, (..., *shape) int64 in [0, 2^32)."""
    y0, y1 = _hash_iota(keys, shape)
    return y0 ^ y1


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from 32-bit words: the 23 high bits as the
    mantissa of a float in [1, 2), minus 1."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA contracts a multiply and an
    add on the CPU (and as ``fmaf`` on the card): the float64 product of two
    float32 values is exact, and the float64 sum rounds to float32 as the
    fused operation does except where the double rounding meets a tie, about
    once in 2^29 operations."""
    f64 = lambda t: (t.double() if torch.is_tensor(t) else float(t))
    out = f64(a) * f64(b) + f64(c)
    return out.float()


def _affine(unit: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    return torch.clamp_min(fma(unit, scale, float(lo)), float(lo))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The float32 inverse error function ``lax.erf_inv`` lowers to (not
    ``torch.erfinv``'s): a degree-8 polynomial in w = -log1p(-x^2) - 2.5
    below w = 5, else in sqrt(w) - 3."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])
    p = coef(0)
    for i in range(1, 9):
        p = fma(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def unit_to_normal(unit: torch.Tensor) -> torch.Tensor:
    """Standard normals from uniforms in [0, 1), as ``jax.random.normal``."""
    return _SQRT2 * erfinv(_affine(unit, _NORMAL_LO, 1.0))


# ---- the plain twins of the CUDA kernels (ops/prng.py) ---------------------

DISTS = ("bits", "uniform", "normal")


def draws(keys: torch.Tensor, n: int, dist: str = "normal") -> torch.Tensor:
    """Kernel (a)'s function: for keys (K, 2), ``n`` draws per key, (K, n):
    ``random_bits`` (int64), ``uniform`` or ``normal`` (float32), each row
    what JAX draws from its key with shape (n,)."""
    if dist not in DISTS:
        raise ValueError(f"dist must be one of {DISTS}, got {dist!r}")
    bits = random_bits(keys, (n,))
    if dist == "bits":
        return bits
    unit = bits_to_unit(bits)
    return unit if dist == "uniform" else unit_to_normal(unit)


PLAN_DISTS = ("uniform", "normal")


def plan(segments: Sequence[Tuple[torch.Tensor, int, str]]) -> Tuple[torch.Tensor, ...]:
    """Kernel (a)'s plan form: for segments (keys, n, dist), keys a (..., 2)
    key view, the draws of :func:`draws` of every segment's keys in one
    float32 buffer, segment after segment; returns a view (*keys.shape[:-1],
    n) of it per segment."""
    counts = [math.prod(k.shape[:-1]) * n for k, n, _ in segments]
    out = torch.empty(sum(counts), dtype=torch.float32, device=segments[0][0].device)
    views, at = [], 0
    for (keys, n, dist), c in zip(segments, counts):
        view = out[at:at + c].view(*keys.shape[:-1], n)
        view.copy_(draws(keys.reshape(-1, 2), n, dist).view(view.shape))
        views.append(view)
        at += c
    return tuple(views)


