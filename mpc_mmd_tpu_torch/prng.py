"""The JAX package's random numbers, in plain PyTorch.

A copy of ``jax.random`` as far as the JAX package uses it, with the
threefry-2x32 key chain of jax 0.9 under ``jax_threefry_partitionable``
(the default since jax 0.5) and 32-bit integers (``jax_enable_x64`` off):

* a key is a pair of uint32 words held in an int64 tensor (..., 2) and
  masked to 32 bits; a batch of keys carries leading axes, and every
  function below maps over them as ``jax.vmap`` would;
* :func:`threefry2x32` is the 20-round hash (rotations 13, 15, 26, 6 and
  17, 29, 16, 24; key schedule with 0x1BD11BDA), on Python ints or int64
  tensors alike (jax/_src/prng.py:1092);
* :func:`key` is ``PRNGKey`` (prng.py:802), :func:`split` the fold-like
  split (prng.py:1156) and :func:`random_bits` the partitionable bits,
  ``out1 ^ out2`` of the hash of the element's 64-bit flat index
  (prng.py:989,1184);
* :func:`uniform`, :func:`normal` (uniform on [nextafter(-1, 0), 1), then
  sqrt(2) erfinv with the float32 polynomial ``lax.erf_inv`` lowers to),
  :func:`multivariate_normal` (Cholesky), :func:`choice` (with ``p``, and
  without replacement), :func:`exponential`, :func:`loggamma` (one key per
  element, Marsaglia-Tsang loops with their own splits, in log space as
  ``beta`` draws) and :func:`beta` (jax/_src/random.py:435-1470).

Bits, uniforms and choices equal JAX's exactly.  XLA contracts a multiply
and an add into one rounding (:func:`fma`) in the uniforms' affine map,
the erfinv polynomial and the gamma loop's ``1 + x c``, and so does this
copy.  Normals, gamma and Beta draws go through ``log1p``, ``log`` and
``exp``, whose float32 results differ from XLA's by an ulp now and then,
so they agree within a few ulp; ``tests/test_torch_prng.py`` states and
prints the gaps.

:func:`draws` and :func:`beta_draws` are the plain twins of the CUDA
kernels in ``ops/prng.py``: a batch of keys to bits, uniforms or normals,
and Beta draws whose element keys are shared along a batch axis.  Nothing
here synchronises with a device beyond what a masked loop needs (the
gamma loops ask whether any element is still rejected).
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
_ONE_THIRD = float(np.float32(1.0 / 3.0))
_SQUEEZE = float(np.float32(0.0331))
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


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers: (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


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


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    return torch.stack(_hash_iota(keys, (num,)), dim=-1)


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


def uniform(keys: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: float32 in [minval, maxval)."""
    return _affine(bits_to_unit(random_bits(keys, shape)), minval, maxval)


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


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal``: float32 (..., *shape)."""
    return unit_to_normal(bits_to_unit(random_bits(keys, shape)))


def multivariate_normal(keys: torch.Tensor, mean: torch.Tensor,
                        cov: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.multivariate_normal`` (Cholesky): mean + L z with z of
    shape (..., *shape, n)."""
    z = normal(keys, (*_shape(shape), mean.shape[-1]))
    factor = torch.linalg.cholesky(cov)
    return mean + (z[..., None, :] * factor).sum(-1)


def exponential(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential``: -log1p(-u)."""
    return -torch.log1p(-uniform(keys, shape))


def choice(k: torch.Tensor, a, shape: Shape = (), replace: bool = True,
           p=None) -> torch.Tensor:
    """``jax.random.choice`` from a 1-D ``a`` (or ``arange(a)``): with ``p``
    and replacement (inverse CDF of ``1 - u``, one key), or without ``p``
    and without replacement (a prefix of :func:`permutation`; keys (..., 2)
    give (..., *shape))."""
    arr = (torch.arange(int(a), device=k.device) if isinstance(a, (int, np.integer))
           else torch.as_tensor(a, device=k.device))
    shape = _shape(shape)
    n_draws = math.prod(shape)
    if p is not None and replace:
        p_cuml = torch.cumsum(torch.as_tensor(p, dtype=torch.float32,
                                              device=k.device), 0)
        r = p_cuml[-1] * (1.0 - uniform(k, shape))
        ind = torch.searchsorted(p_cuml, r.reshape(-1)).reshape(shape)
        return arr[ind]
    if p is None and not replace:
        if n_draws > arr.shape[0]:
            raise ValueError(f"Cannot take a larger sample (size {n_draws}) than "
                             f"population (size {arr.shape[0]}) when "
                             f"'replace=False'")
        out = permutation(k, arr)[..., :n_draws]
        return out.reshape(*k.shape[:-1], *shape)
    raise NotImplementedError("choice: the JAX package draws with p and "
                              "replacement, or without p and without replacement")


def permutation(k: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``jax.random.permutation`` of a 1-D tensor under each key of k (...,
    2): rounds of a stable sort by fresh 32-bit keys, ceil(3 ln n /
    ln(2^32 - 1)) of them; (..., n)."""
    n = x.shape[0]
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    x = x.expand(*k.shape[:-1], n)
    for _ in range(rounds):
        k, sub = split(k).unbind(-2)
        x = torch.gather(x, -1, torch.argsort(random_bits(sub, (n,)), dim=-1,
                                              stable=True))
    return x


def _rejected(X, V, U, d):
    """``_gamma_one``'s loop condition: the squeeze test and the log test
    both fail (the initial X = 0, V = 1, U = 2 enters the loop unless d is
    not finite)."""
    return ((U >= 1.0 - _SQUEEZE * (X * X))
            & (torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V))))


def _loggamma_one(keys: torch.Tensor, alpha: torch.Tensor, tally: dict = None
                  ) -> torch.Tensor:
    """``_gamma_one`` in log space (jax/_src/random.py:1298) for every
    element: keys (n, 2), alpha (n,) float32.  Marsaglia and Tsang's
    rejection loop, with alpha < 1 boosted to alpha + 1 and log(u) / alpha
    added, run as a masked loop over the elements still rejected.
    ``tally``, if given, gains the rounds of the outer and the inner loop
    summed over the elements ("outer", "inner"); if it holds "group", an
    id per element, equal where elements share their keys, it also gains
    those rounds counted once a group ("outer_chains", "inner_chains"):
    a round's keys and draws depend only on the key and the round."""
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - _ONE_THIRD
    # a tensor quotient: ``float / tensor`` is a reciprocal times the float,
    # two roundings where JAX and the kernel divide once
    c = torch.full_like(d, _ONE_THIRD) / torch.sqrt(d)
    k, sub = split(keys).unbind(-2)
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)
    live = _rejected(X, V, U, d)
    group = tally.get("group") if tally is not None else None

    def count(name, at):
        tally[name] = tally.get(name, 0) + len(at)
        if group is not None:
            tally[name + "_chains"] = (tally.get(name + "_chains", 0)
                                       + len(torch.unique(group[at])))

    while bool(live.any()):
        idx = live.nonzero().squeeze(1)
        if tally is not None:
            count("outer", idx)
        kn, xk, uk = split(k[idx], 3).unbind(-2)
        ci = c[idx]
        x = torch.zeros_like(ci)
        v = torch.full_like(ci, -1.0)
        redo = torch.ones_like(live[idx])
        while bool(redo.any()):
            j = redo.nonzero().squeeze(1)
            if tally is not None:
                count("inner", idx[j])
            kk, s = split(xk[j]).unbind(-2)
            xk[j] = kk
            x[j] = normal(s)
            v[j] = fma(x[j], ci[j], 1.0)
            redo = v <= 0.0
        Xi, Vi = x * x, (v * v) * v
        Ui = uniform(uk)
        k[idx], X[idx], V[idx], U[idx] = kn, Xi, Vi, Ui
        live[idx] = _rejected(Xi, Vi, Ui, d[idx])
    log_u = torch.log1p(-uniform(sub))
    log_boost = torch.where(boost | (log_u == 0.0), 0.0, log_u * (1.0 / alpha))
    return (torch.log(d) + torch.log(V)) + log_boost


def loggamma(keys: torch.Tensor, a, shape: Shape = None) -> torch.Tensor:
    """``jax.random.loggamma``: ``a`` is broadcast to ``keys.shape[:-1] +
    shape`` and each key split into one key per element of ``shape``."""
    lead = keys.shape[:-1]
    a = torch.as_tensor(a, dtype=torch.float32, device=keys.device)
    shape = _shape(shape) if shape is not None else tuple(a.shape[len(lead):])
    a = torch.broadcast_to(a, (*lead, *shape))
    elem = split(keys, math.prod(shape))
    out = _loggamma_one(elem.reshape(-1, 2), a.reshape(-1))
    return out.reshape(*lead, *shape)


def _ratio(log_ga: torch.Tensor, log_gb: torch.Tensor) -> torch.Tensor:
    """G_a / (G_a + G_b) from the logs, without overflow (random.py:1133)."""
    log_max = torch.maximum(log_ga, log_gb)
    ga = torch.exp(log_ga - log_max)
    gb = torch.exp(log_gb - log_max)
    return ga / (ga + gb)


def beta(keys: torch.Tensor, a, b, shape: Shape = None) -> torch.Tensor:
    """``jax.random.beta``: log-space gammas from the two halves of
    ``split(key)``, combined as G_a / (G_a + G_b)."""
    ka, kb = split(keys).unbind(-2)
    return _ratio(loggamma(ka, a, shape), loggamma(kb, b, shape))


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


def beta_draws(keys: torch.Tensor, alpha: torch.Tensor, beta_: torch.Tensor,
               n: int, tally: dict = None) -> torch.Tensor:
    """Kernel (b)'s function: Beta draws (K, B, n) for keys (K, 2) and
    parameters (K, B, P), n a multiple of P; element e of row (k, b) takes
    the parameters (k, b, e mod P).

    Row (k, b) is ``jax.random.beta(keys[k], a, b, shape)`` with the
    parameters broadcast over ``shape`` (n = prod(shape), e its flat index)
    and its element keys shared by every b: the JAX package ``vmap``s a
    draw over candidates with a key closed over, and the batching rule of
    ``random_gamma`` gives every candidate the same split.  ``tally`` as
    in :func:`_loggamma_one`, over both gammas of every element, with the
    rounds of each (key, element) chain also counted once.
    """
    K, B, P = alpha.shape
    if n % P:
        raise ValueError(f"beta_draws: n = {n} is not a multiple of P = {P}")
    ka, kb = split(keys).unbind(-2)                     # (K, 2) each
    rep = lambda t: t[:, :, None, :].expand(K, B, n // P, P).reshape(-1)
    out = []
    if tally is not None:
        tally["group"] = torch.arange(K * n, device=keys.device).view(K, 1, n).expand(
            K, B, n).reshape(-1)
    for k, par in ((ka, alpha), (kb, beta_)):
        elem = split(k, n)[:, None].expand(K, B, n, 2).reshape(-1, 2)
        out.append(_loggamma_one(elem, rep(par.to(torch.float32)), tally))
    if tally is not None:
        del tally["group"]
    return _ratio(*out).view(K, B, n)
