"""The JAX key chain's draws on the card (CUDA source ``csrc/prng.cu``).

Two kernels, neither a TPU kernel: the JAX package draws through XLA's
lowering of ``jax.random`` (threefry2x32, ``normal``, ``gamma``, ``beta``),
and these replace that lowering for the port's noise
(``noise.JaxNoise``).

* :func:`prng_draws`, kernel (a): a batch of keys to bits, uniforms or
  normals, ``n`` per key, in one launch: every Gaussian family of a solve
  or a validation.  Bound by its integer operations (about 73 a hash, one
  hash an element); the note in the CUDA source has the numbers.
* :func:`prng_beta`, kernel (b): Beta draws, ``jax.random.gamma``'s
  Marsaglia-Tsang loops for both halves in log space.  The candidates of a
  key share each element's key chain, so a block hashes each chain once a
  round into shared memory and its candidates run their own acceptance
  tests on it (one thread an element where there is one candidate).  The
  function is bound by the candidates' float operations; the kernel waits
  on a chain's dependent hashes (the note in the CUDA source).

Each takes its plain twin (``prng.draws``, ``prng.beta_draws``) for CPU
tensors and launches its kernel for CUDA tensors, counting launches in
``.launches``.
"""

from __future__ import annotations

import torch

from . import _build
from .. import prng

_DIST_CODE = {"bits": 0, "uniform": 1, "normal": 2}


def _require_keys(name: str, keys: torch.Tensor) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"{name}: keys must be int64 (K, 2), got "
                         f"{keys.dtype} {tuple(keys.shape)}")


def prng_draws(keys: torch.Tensor, n: int, dist: str = "normal") -> torch.Tensor:
    """``n`` draws per key of keys (K, 2) int64: (K, n) int64 bits in
    [0, 2^32) (``dist="bits"``), or float32 uniforms or standard normals;
    row k is ``jax.random.normal(keys[k], (n,))`` (or ``uniform``,
    ``bits``)."""
    _require_keys("prng_draws", keys)
    if dist not in _DIST_CODE:
        raise ValueError(f"prng_draws: dist must be one of {tuple(_DIST_CODE)}, "
                         f"got {dist!r}")
    if keys.device.type == "cpu":
        return prng.draws(keys, n, dist)
    if keys.device.type != "cuda" or keys.device.index != torch.cuda.current_device():
        raise ValueError(f"prng_draws: keys on {keys.device}, not the current "
                         f"CUDA device")
    keys = keys.contiguous()
    K = keys.shape[0]
    out = torch.empty((K, n), dtype=torch.int32 if dist == "bits" else torch.float32,
                      device=keys.device)
    err = _build.library().mmd_prng_draws(keys.data_ptr(), K, n, _DIST_CODE[dist],
                                          out.data_ptr(), _build.stream())
    _build.check(err, "prng_draws")
    prng_draws.launches += 1
    return out.to(torch.int64) & prng.M32 if dist == "bits" else out


def prng_beta(keys: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
              n: int) -> torch.Tensor:
    """Beta draws (K, B, n) for keys (K, 2) int64 and parameters alpha,
    beta (K, B, P), n a multiple of P (see ``prng.beta_draws``: element e
    of row (k, b) takes the parameters at e mod P, and its keys are shared
    by every b)."""
    _require_keys("prng_beta", keys)
    if alpha.dim() != 3 or beta.shape != alpha.shape or alpha.shape[0] != keys.shape[0]:
        raise ValueError(f"prng_beta: alpha {tuple(alpha.shape)} and beta "
                         f"{tuple(beta.shape)} must be one (K, B, P) with K = "
                         f"{keys.shape[0]}")
    K, B, P = alpha.shape
    if n % P:
        raise ValueError(f"prng_beta: n = {n} is not a multiple of P = {P}")
    if keys.device.type == "cpu":
        return prng.beta_draws(keys, alpha, beta, n)
    _build.require_cuda_f32("prng_beta", alpha, beta)
    if keys.device != alpha.device:
        raise ValueError(f"prng_beta: keys on {keys.device}, parameters on "
                         f"{alpha.device}")
    keys = keys.contiguous()
    out = torch.empty((K, B, n), dtype=torch.float32, device=alpha.device)
    err = _build.library().mmd_prng_beta(keys.data_ptr(), alpha.data_ptr(),
                                         beta.data_ptr(), K, B, n, P,
                                         out.data_ptr(), _build.stream())
    _build.check(err, "prng_beta")
    prng_beta.launches += 1
    return out


prng_draws.launches = 0
prng_beta.launches = 0
