# Frozen copy of mpc_mmd_tpu_torch/noise.py (commit eb91b04) cut to the
# Gaussian draws of JaxNoise: every hand-written kernel call taken out, so
# this runs PyTorch operations on any device.  The benchmark's yardstick: do not
# edit it to follow the port.
"""The JAX package's draws of a solve, from its own keys (``prng.py``).

Every multivariate-normal draw of the path is ``mean + z @ chol(cov).T``
(equal to ``jax.random.multivariate_normal`` of the same key for an
identity covariance), so standard-normal ``z`` is all a source supplies
there.  :class:`JaxNoise` draws what the JAX package draws, so a solve of
``idx_mpc`` meets the JAX solve's numbers (the port's other sources, its
Beta draws and the validator's are the port's).

Draws, and where the JAX package makes them:

* ``initial_z`` (nb, 8): the initial parameter batch.  The JAX package
  reuses ``split(PRNGKey(0))[0]`` for every solve (sampling.py:34-39), so
  a solver draws it once.
* ``inner_cem``: ``samples0`` (S, M+1), ``u`` (maxiter, S-n_el, n_el) and
  ``z`` (maxiter, S-n_el, M+1) of the inner beta-CEM, keyed from
  ``PRNGKey(0)`` (reduced_set.py:432-466) and so also drawn once.
* per outer iteration ``it``, with ``k_roll = split(PRNGKey(3*idx_mpc +
  5*it + 7))[0]`` (solver.py:186,202): the rollout normals ``eps_acc``
  from ``k_roll``, ``eps_steer`` from ``split(k_roll)[0]`` and
  ``eps_const`` from ``split(split(k_roll)[0])[0]``, each (R, T) and
  shared by all candidates (solver.py:115-116, dynamics.py:91-120); and
  ``cem_z`` (nb - ellite_num, 8) for the resample of the outer CEM update
  (solver.py:299).
* the Frenet solve, once per solve: ``init_state_z(init_key(idx_mpc), n)``
  (n, 4), the standard normals of ``split(PRNGKey(idx_mpc))[0]`` behind
  its n noisy initial states (solver_frenet.py:52-64); n is
  :func:`init_state_count`.

A chunk of N scenarios asks for its per-iteration draws through a key
table, ``keys(seeds, iterations)``: a row per scenario holding each
iteration's three keys k_roll, k_steer and k_const of the scenario's
``idx_mpc``.  ``solve_draws(table, R, T, n_cem, n_params, init)`` returns
every per-iteration family at once, a :class:`SolveDraws` of views per
outer iteration, and, given ``init`` = (init_key, n), the initial states'
normals.  The JAX package draws them inside its ``lax.scan``; threefry is
counter-based, so drawing them first changes no value.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from .device import to_device


def init_state_count(cfg) -> int:
    """Noisy initial states of a Frenet solve: M in ``mmd_opt`` (one per
    mother rollout), 1 in ``det``, else R."""
    return {"mmd_opt": cfg.risk.num_mother, "det": 1}.get(cfg.risk.mode,
                                                          cfg.risk.num_reduced)


class InnerDraws(NamedTuple):
    samples0: torch.Tensor      # (S, M+1) standard normal
    u: torch.Tensor             # (maxiter, S - n_el, n_el)
    z: torch.Tensor             # (maxiter, S - n_el, M + 1)


class SolveDraws(NamedTuple):
    """A solve's Gaussian draws, per outer iteration (``solve_draws``)."""
    eps: Optional[Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]]
    #   eps_acc, eps_steer, eps_const (N, R, T) an iteration; None without rollouts
    cem_z: Tuple[torch.Tensor, ...]     # (N, n_cem, n_params) an iteration
    init_z: Optional[torch.Tensor]      # (n, 4) the noisy initial states', or None


def _first(k: Tuple[int, int]) -> Tuple[int, int]:
    """``split(k)[0]`` of a key held as two ints."""
    return prng.threefry2x32(k[0], k[1], 0, 0)


def _seed_key(seed: int) -> Tuple[int, int]:
    return (0, int(seed) & prng.M32)


class JaxNoise:
    """The JAX package's draws, from its own key chain (the default noise).

    Keys are derived on the host (``prng.threefry2x32`` on Python ints, or
    on int64 arrays for a key table) and reach ``device``; each family is
    drawn by ``prng.draws`` or ``prng.plan``.  Every draw is
    ``jax.random``'s for the same key and shape, normals to within a few
    ulp (``prng.py``).
    """

    def __init__(self, device):
        self.device = torch.device(device)

    def _keys(self, keys) -> torch.Tensor:
        if not torch.is_tensor(keys):
            keys = torch.tensor(keys, dtype=torch.int64)
        return to_device(keys.reshape(-1, 2), self.device)

    def _normal(self, keys, shape) -> torch.Tensor:
        """Standard normals (len(keys), *shape), each row one key's."""
        keys = self._keys(keys)
        return prng.draws(keys, math.prod(shape), "normal").view(-1, *shape)

    def initial_z(self, nb: int, n_params: int) -> torch.Tensor:
        return self._normal([_first(_seed_key(0))], (nb, n_params))[0]

    def _inner_keys(self, maxiter: int):
        """init_key = split(key0)[0] with key0 = split(PRNGKey(0))[0], and per
        inner iteration the update key split(split(carried key)[0])[0]."""
        key0 = _first(_seed_key(0))
        kc, upd = key0, []
        for _ in range(maxiter):
            kc = _first(kc)
            upd.append(_first(kc))
        return _first(key0), upd

    def inner_cem(self, S: int, M: int, n_el: int, maxiter: int) -> InnerDraws:
        init_key, upd = self._inner_keys(maxiter)
        ku_kz = [prng.split_int(k) for k in upd]
        return InnerDraws(self._normal([init_key], (S, M + 1))[0],
                          self._normal([k[0] for k in ku_kz], (S - n_el, n_el)),
                          self._normal([k[1] for k in ku_kz], (S - n_el, M + 1)))

    @staticmethod
    def keys(seeds: Sequence[int], iterations: int) -> torch.Tensor:
        """The key table (N, iterations, 3, 2) int64 of a chunk: per
        scenario and outer iteration ``it``, k_roll = split(PRNGKey(3 *
        idx_mpc + 5 * it + 7))[0], k_steer = split(k_roll)[0] (also the
        outer CEM's key) and k_const = split(k_steer)[0], each two uint32
        words (``prng.threefry2x32`` on int64 arrays)."""
        s = np.array([int(x) for x in seeds], dtype=np.int64)[:, None]
        it = np.arange(iterations, dtype=np.int64)[None]
        k = (0, (3 * s + 5 * it + 7) & prng.M32)
        chain = []
        for _ in range(3):
            k = prng.threefry2x32(k[0], k[1], 0, 0)
            chain.append(np.stack(np.broadcast_arrays(*k), axis=-1))
        return torch.from_numpy(np.stack(chain, axis=-2))

    def plan(self, keys: torch.Tensor, R: Optional[int], T: int, n_cem: int,
             n_params: int, init=None):
        """The segments of a solve's draws (``ops.prng_plan``) from the key
        table (N, I, 3, 2), read where it lies: the rollout noise (I, 3, N,
        R T) from every key of the table (none with R None), the resample
        (I, N, n_cem n_params) from each k_steer and the noisy initial
        states' normals from ``init`` = (init_key, n)."""
        keys = to_device(keys, self.device)
        segments = [] if R is None else [(keys.permute(1, 2, 0, 3), R * T, "normal")]
        segments.append((keys[:, :, 1].transpose(0, 1), n_cem * n_params, "normal"))
        if init is not None:
            segments.append((self._keys(init[0]), init[1] * 4, "normal"))
        return segments

    def solve_draws(self, keys: torch.Tensor, R: Optional[int], T: int, n_cem: int,
                    n_params: int, init=None) -> SolveDraws:
        """One launch of kernel (a)'s plan form (``ops.prng_plan``) of
        :meth:`plan`'s segments; an iteration's views are contiguous."""
        N, I = keys.shape[:2]
        out = list(prng.plan(self.plan(keys, R, T, n_cem, n_params, init)))
        eps = None if R is None else out.pop(0).view(I, 3, N, R, T)
        z = out.pop(0).view(I, N, n_cem, n_params)
        return SolveDraws(None if eps is None else tuple(tuple(e.unbind(0)) for e in eps),
                          tuple(z.unbind(0)),
                          out.pop(0).view(init[1], 4) if init is not None else None)

    @staticmethod
    def init_key(idx_mpc: int) -> torch.Tensor:
        """split(PRNGKey(idx_mpc))[0], (2,) int64."""
        return torch.tensor(_first(_seed_key(idx_mpc)), dtype=torch.int64)
