"""The single injection point for every random draw of the solve.

The solve never draws itself: it asks a noise source for standard-normal
and Beta tensors, and the shapes and sharing below are those of the JAX
package's key chain.  Every multivariate-normal draw of the path is
``mean + z @ chol(cov).T`` (equal to ``jax.random.multivariate_normal`` of
the same key for an identity covariance), so standard-normal ``z`` is all
a source supplies there.

Sources: :class:`JaxNoise`, the default of every entry point, draws what
the JAX package draws, from its own keys (``prng.py``, through the CUDA
kernels of ``ops/prng.py`` on the card), so a solve of ``idx_mpc`` meets
the JAX solve's numbers; :class:`TorchNoise` draws from a re-seeded
``torch.Generator`` and :class:`FixedNoise` replays given arrays, for the
tests and for recorded draws.

Draws, in the order a solve asks for them, and where the JAX package makes
them:

* ``initial_z`` (nb, 8): the initial parameter batch.  The JAX package
  reuses ``split(PRNGKey(0))[0]`` for every solve (sampling.py:34-39), so
  a solver draws it once.
* ``inner_cem``: ``samples0`` (S, M+1), ``u`` (maxiter, S-n_el, n_el) and
  ``z`` (maxiter, S-n_el, M+1) of the inner beta-CEM, keyed from
  ``PRNGKey(0)`` (reduced_set.py:432-466) and so also drawn once.
* per outer iteration ``it``, with ``k_roll = split(PRNGKey(3*idx_mpc +
  5*it + 7))[0]`` (solver.py:186,202):

  - ``rollout_eps``: ``eps_acc`` from ``k_roll``, ``eps_steer`` from
    ``split(k_roll)[0]`` and ``eps_const`` from ``split(split(k_roll)[0])[0]``,
    each (R, T) and shared by all candidates (the JAX key is closed over in
    the vmap, solver.py:115-116, dynamics.py:91-120).  Under Beta noise
    only ``eps_const`` is used.
  - ``rollout_beta``, Beta noise only: the acc draw from ``k_roll``, the
    steer draw from ``split(k_roll)[0]`` (dynamics.py:110-114), each
    (C, R, T).  Their parameters depend on every candidate's controls, so
    they are drawn during the solve, after the controls; the JAX package
    draws every candidate's from the same key.
  - ``cem_z`` (nb - ellite_num, 8) for the resample of the outer CEM
    update (solver.py:299).

The per-iteration families are asked for by a chunk of N scenarios at
once (``Solver.solve`` is a chunk of one), through a key table: the
solve's prologue asks the source for ``keys(seeds, iterations)``, a host
tensor with a row per scenario and a column per outer iteration, and the
solve hands column ``it`` (``table[:, it]``, on the solve's device) to
``rollout_eps``, ``rollout_beta`` and ``cem_z``, which return the
scenarios' draws stacked on a leading axis.  What a row holds is the
source's own: :class:`JaxNoise` the iteration's three keys k_roll, k_steer
and k_const of the scenario's ``idx_mpc`` (so a chunk's keys are drawn in
one launch), :class:`FixedNoise` and :class:`TorchNoise` the pair
(idx_mpc, it).  The table is an input of the solve, so a solve captured in
a CUDA graph (``graph.py``) draws the keys of the scenarios it is replayed
for.  A scenario meets the same draws in a chunk as alone; the
solver-fixed draws stay shared by every scenario.

Under the ``exact`` strategy the inner CEM asks for ``inner_exact``:
``samples0`` as above (the JAX package draws it from the same key with
the covariance ``init_cov_scale * I``) and ``z`` (maxiter, S-n_el, M+1),
the standard normals of the multivariate normal that each iteration draws
straight from its update key ``split(split(key)[0])[0]``
(reduced_set.py:289-291,315-317).

The Frenet solve (``solver_frenet.py``) asks first, once per solve, for
``init_state_z(init_key(idx_mpc), n)`` (n, 4): the standard normals of
``split(PRNGKey(idx_mpc))[0]`` behind its n noisy initial states
(solver_frenet.py:52-64; the identity covariance makes the multivariate
normal equal to z); the key is an input of the solve, as the table is.  n is
:func:`init_state_count`.  Its outer iterations draw from the keys above
(solver_frenet.py:149,164,256), so they ask for the same families.

The Monte-Carlo validator (``validate.py``) asks for ``mc_draws``: per
solve row r of a validation with seed s, the JAX package keys
``split(split(PRNGKey(s), S)[r], 3)`` (validate.py:45,127) and draws from
the three keys (n_mc, T) each: ``eps_acc`` and ``eps_steer``, standard
normal, or under Beta noise the acc and steer Beta draws instead, and
``eps_const``.  A source draws them per (seed, row), so a solve's draws
do not depend on how the validator chunks the solves, and every mode of a
comparison meets the same draws in the same row.  (Split keys are
fold-like, ``jax_threefry_partitionable``: row r's key does not depend on
how many solves the validation holds.)
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import prng
from .device import to_device
from .ops import prng_beta, prng_draws


def init_state_count(cfg) -> int:
    """Noisy initial states of a Frenet solve: M in ``mmd_opt`` (one per
    mother rollout), 1 in ``det``, else R."""
    return {"mmd_opt": cfg.risk.num_mother, "det": 1}.get(cfg.risk.mode,
                                                          cfg.risk.num_reduced)


class InnerDraws(NamedTuple):
    samples0: torch.Tensor      # (S, M+1) standard normal
    u: torch.Tensor             # (maxiter, S - n_el, n_el)
    z: torch.Tensor             # (maxiter, S - n_el, M + 1)


class ExactInnerDraws(NamedTuple):
    samples0: torch.Tensor      # (S, M+1) standard normal, InnerDraws' own
    z: torch.Tensor             # (maxiter, S - n_el, M + 1)


def _seed_table(seeds: Sequence[int], iterations: int) -> torch.Tensor:
    """(N, iterations, 2) int64: each scenario's (idx_mpc, it) pairs."""
    s = torch.as_tensor([int(x) for x in seeds], dtype=torch.int64)
    it = torch.arange(iterations, dtype=torch.int64)
    return torch.stack(torch.broadcast_tensors(s[:, None], it[None]), dim=-1)


def sample_beta(alpha: torch.Tensor, beta: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """Beta(alpha, beta) draws of the broadcast shape, in log space.

    ``log G(a) = log G(a + 1) + log(U) / a`` for a gamma variate G and a
    uniform U in (0, 1], and ``Beta = sigmoid(log G_a - log G_b)``: the way
    ``jax.random.beta`` samples.  The plain forms are wrong at the
    parameters the solve meets: every candidate's steer is exactly 0 at
    t = 0, so a = 2e-8, where gamma draws underflow float32 and
    ``torch.distributions.Beta`` and ``G_a / (G_a + G_b)`` return a mean of
    1/2 instead of a / (a + b).  In log space the draw becomes the
    Bernoulli(a / (a + b)) on {0, 1} that Beta tends to as a, b -> 0.
    """
    alpha, beta = torch.broadcast_tensors(alpha, beta)

    def log_gamma(a):
        g = torch._standard_gamma(a + 1.0, generator=generator)
        u = 1.0 - torch.rand(a.shape, generator=generator, device=a.device,
                             dtype=a.dtype)
        return torch.log(g) + torch.log(u) / a

    return torch.sigmoid(log_gamma(alpha) - log_gamma(beta))


class TorchNoise:
    """Draws on ``device`` from a re-seeded ``generator`` (for tests that
    need a second draw independent of the JAX package's numbers).

    Each family of draws re-seeds the generator from a fixed tuple, so a
    solve is a function of its ``idx_mpc`` (as in the JAX package, whose
    outer keys are ``PRNGKey(3*idx_mpc + 5*it + 7)``), and the draws made
    once per solver come out the same for every solver.  Its key table
    holds (idx_mpc, it) pairs, which the draws read on the host: a CUDA
    graph cannot replay them, so a graphed solver refuses this source
    (``capturable``).
    """

    capturable = False

    def __init__(self, generator: torch.Generator, device):
        self.device = torch.device(device)
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, "
                             f"noise on {self.device}")
        self.generator = generator

    def _seed(self, seed: Tuple[int, ...]) -> torch.Generator:
        self.generator.manual_seed(hash(seed) & (2 ** 63 - 1))
        return self.generator

    def _randn(self, seed: Tuple[int, ...], *shapes):
        g = self._seed(seed)
        return tuple(torch.randn(s, generator=g, device=self.device)
                     for s in shapes)

    def initial_z(self, nb: int, n_params: int) -> torch.Tensor:
        return self._randn((0,), (nb, n_params))[0]

    def inner_cem(self, S: int, M: int, n_el: int, maxiter: int) -> InnerDraws:
        return InnerDraws(*self._randn(
            (1,), (S, M + 1), (maxiter, S - n_el, n_el),
            (maxiter, S - n_el, M + 1)))

    def inner_exact(self, S: int, M: int, n_el: int, maxiter: int
                    ) -> ExactInnerDraws:
        return ExactInnerDraws(self._randn((1,), (S, M + 1))[0],
                               self._randn((7,), (maxiter, S - n_el, M + 1))[0])

    def keys(self, seeds: Sequence[int], iterations: int) -> torch.Tensor:
        """(N, iterations, 2) int64: each scenario's (idx_mpc, it)."""
        return _seed_table(seeds, iterations)

    def rollout_eps(self, keys: torch.Tensor, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        eps = [self._randn((2, s, it), (R, T), (R, T), (R, T))
               for s, it in keys.tolist()]
        return tuple(torch.stack(e) for e in zip(*eps))

    def rollout_beta(self, keys: torch.Tensor, R: int, alpha: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
        """Beta draws (2, N, C, R, T) for parameters alpha, beta (2, N, C,
        T) of the (acc, steer) channels; R draws per candidate and step."""
        out = []
        for i, (s, it) in enumerate(keys.tolist()):
            g = self._seed((4, s, it))
            a, b = alpha[:, i], beta[:, i]
            shape = (a.shape[0], a.shape[1], R, a.shape[2])
            out.append(sample_beta(a[:, :, None].expand(shape),
                                   b[:, :, None].expand(shape), g))
        return torch.stack(out, dim=1)

    def cem_z(self, keys: torch.Tensor, n: int, n_params: int) -> torch.Tensor:
        return torch.stack([self._randn((3, s, it), (n, n_params))[0]
                            for s, it in keys.tolist()])

    def init_key(self, idx_mpc: int) -> torch.Tensor:
        return torch.tensor([int(idx_mpc)], dtype=torch.int64)

    def init_state_z(self, key: torch.Tensor, n: int) -> torch.Tensor:
        return self._randn((6, int(key[0])), (n, 4))[0]

    def gmm_init_draws(self, idx_mpc: int, n: int, probs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sampling.gmm_noisy_init_state``'s draws: standard normals
        (n, 4) and each member's mode (n,) in {1, 2, 3} with the
        probabilities ``probs``."""
        z, = self._randn((8, idx_mpc), (n, 4))
        p = torch.tensor(probs, dtype=torch.float32, device=self.device)
        modes = torch.multinomial(p, n, replacement=True,
                                  generator=self.generator) + 1
        return z, modes

    def mc_draws(self, seed: int, rows, n_mc: int, T: int, params=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The validator's draws of the solve rows ``rows``: ``d_acc``,
        ``d_steer`` and ``eps_const``, each (len(rows), n_mc, T).

        Gaussian noise (``params`` None): standard normals.  Beta noise:
        ``params`` = (alpha, beta), each (2, len(rows), T) for the (acc,
        steer) channels, and ``d_acc``, ``d_steer`` are Beta draws.  Each
        row re-seeds the generator from (seed, row).
        """
        out = torch.empty((len(rows), 3, n_mc, T), device=self.device)
        for i, r in enumerate(rows):
            g = self._seed((5, int(seed), int(r)))
            if params is None:
                torch.randn((3, n_mc, T), generator=g, out=out[i])
            else:
                shape = (2, n_mc, T)
                out[i, :2] = sample_beta(params[0][:, i, None].expand(shape),
                                         params[1][:, i, None].expand(shape), g)
                torch.randn((n_mc, T), generator=g, out=out[i, 2])
        return out[:, 0], out[:, 1], out[:, 2]


def _first(k: Tuple[int, int]) -> Tuple[int, int]:
    """``split(k)[0]`` of a key held as two ints."""
    return prng.threefry2x32(k[0], k[1], 0, 0)


def _seed_key(seed: int) -> Tuple[int, int]:
    return (0, int(seed) & prng.M32)


class JaxNoise:
    """The JAX package's draws, from its own key chain (the default noise).

    Keys are derived on the host (``prng.threefry2x32`` on Python ints, or
    on int64 arrays for a key table or the validator's rows) and reach
    ``device`` without a host sync; each family is drawn in one call of
    ``ops.prng_draws`` (standard normals, uniforms) or ``ops.prng_beta``
    (Beta): the CUDA kernels on the card, their plain twins on the CPU.
    Every draw is ``jax.random``'s for the same key and shape, normals and
    Beta draws to within a few ulp (``prng.py``).
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
        return prng_draws(keys, math.prod(shape), "normal").view(-1, *shape)

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

    def inner_exact(self, S: int, M: int, n_el: int, maxiter: int
                    ) -> ExactInnerDraws:
        init_key, upd = self._inner_keys(maxiter)
        return ExactInnerDraws(self._normal([init_key], (S, M + 1))[0],
                               self._normal(upd, (S - n_el, M + 1)))

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

    def rollout_eps(self, keys: torch.Tensor, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """eps_acc, eps_steer, eps_const (N, R, T) from the keys (N, 3, 2)
        of an iteration."""
        eps = self._normal(keys, (R, T)).view(keys.shape[0], 3, R, T)
        return eps[:, 0], eps[:, 1], eps[:, 2]

    def rollout_beta(self, keys: torch.Tensor, R: int, alpha: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
        """Parameters (2, N, C, T): acc draws from each scenario's k_roll,
        steer draws from its k_steer, every candidate from the same element
        keys (2, N, C, R, T)."""
        _, N, C, T = alpha.shape
        draws = prng_beta(self._keys(keys[:, :2].transpose(0, 1)),
                          alpha.reshape(2 * N, C, T).contiguous(),
                          beta.reshape(2 * N, C, T).contiguous(), R * T)
        return draws.view(2, N, C, R, T)

    def cem_z(self, keys: torch.Tensor, n: int, n_params: int) -> torch.Tensor:
        """The outer CEM's resample (N, n, n_params), from k_steer."""
        return self._normal(keys[:, 1], (n, n_params))

    @staticmethod
    def init_key(idx_mpc: int) -> torch.Tensor:
        """split(PRNGKey(idx_mpc))[0], (2,) int64."""
        return torch.tensor(_first(_seed_key(idx_mpc)), dtype=torch.int64)

    def init_state_z(self, key: torch.Tensor, n: int) -> torch.Tensor:
        return self._normal(key, (n, 4))[0]

    def gmm_init_draws(self, idx_mpc: int, n: int, probs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``normal(key, (n, 4))`` and ``choice(key, [1, 2, 3], (n,), p=probs)``
        from the one key split(PRNGKey(idx_mpc))[0] (sampling.py:142-150)."""
        key = _first(_seed_key(idx_mpc))
        z = self._normal([key], (n, 4))[0]
        u = prng_draws(self._keys([key]), n, "uniform")[0]
        p = torch.tensor(probs, dtype=torch.float32)
        p_cuml = torch.cumsum(to_device(p, self.device), 0)
        return z, torch.searchsorted(p_cuml, p_cuml[-1] * (1.0 - u)) + 1

    def mc_draws(self, seed: int, rows, n_mc: int, T: int, params=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Row r's keys k1, k2, k3 = split(split(PRNGKey(seed), S)[r], 3),
        every row in one launch a family (see :meth:`TorchNoise.mc_draws`
        for the shapes and ``params``)."""
        r = torch.as_tensor(list(rows), dtype=torch.int64)
        root = _seed_key(seed)
        row_keys = torch.stack(prng.threefry2x32(root[0], root[1], r >> 32,
                                                 r & prng.M32), dim=-1)
        k = prng.split(row_keys, 3)                          # (S, 3, 2)
        S = len(r)
        if params is None:
            eps = self._normal(k, (n_mc, T)).view(S, 3, n_mc, T)
            return eps[:, 0], eps[:, 1], eps[:, 2]
        alpha, beta = (p.reshape(2 * S, 1, T).contiguous() for p in params)
        b = prng_beta(self._keys(k[:, :2].transpose(0, 1)), alpha, beta, n_mc * T)
        b = b.view(2, S, n_mc, T)
        return b[0], b[1], self._normal(k[:, 2], (n_mc, T))


BetaFn = Callable[[int, int, int, np.ndarray, np.ndarray], np.ndarray]


class FixedNoise:
    """Replays given arrays: the draws of one solve, for tests and checks.

    ``arrays`` holds ``initial_z`` (nb, 8), ``samples0``, ``u``, ``z`` (see
    :class:`InnerDraws`), under the exact strategy ``z_exact`` (see
    :class:`ExactInnerDraws`), and per outer iteration ``eps_acc``,
    ``eps_steer``, ``eps_const`` (maxiter_cem, R, T) and ``cem_z``
    (maxiter_cem, nb - ellite_num, 8), for a Frenet solve
    ``init_state_z`` (n, 4), and for ``sampling.gmm_noisy_init_state``
    ``gmm_z`` (n, 4) and ``gmm_modes`` (n,).  Its key table holds (idx_mpc,
    it) pairs; the replay reads only ``it``, as an index tensor on the
    device (a CUDA graph replays it), so every scenario of a chunk meets
    the same draws.

    Beta draws come from ``arrays["beta"]`` (maxiter_cem, 2, C, R, T) if
    given, else from ``beta_fn(idx_mpc, it, R, alpha, beta)``, which gets
    the parameters (2, C, T) of a scenario as numpy arrays and returns
    (2, C, R, T): a host round trip, which a CUDA graph cannot capture.

    The validator's draws come from ``mc_eps_acc``, ``mc_eps_steer``,
    ``mc_eps_const`` (N, n_mc, T) and, under Beta noise, ``mc_beta``
    (N, 2, n_mc, T), indexed by solve row; the seed is ignored.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], device,
                 beta_fn: Optional[BetaFn] = None):
        self.device = torch.device(device)
        self.arrays = {k: torch.as_tensor(np.array(v, np.float32),
                                          device=self.device)
                       for k, v in arrays.items()}
        self.beta_fn = beta_fn

    def _get(self, name: str, shape) -> torch.Tensor:
        a = self.arrays[name]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: have {tuple(a.shape)}, "
                             f"need {tuple(shape)}")
        return a

    def initial_z(self, nb: int, n_params: int) -> torch.Tensor:
        return self._get("initial_z", (nb, n_params))

    def inner_cem(self, S: int, M: int, n_el: int, maxiter: int) -> InnerDraws:
        return InnerDraws(self._get("samples0", (S, M + 1)),
                          self._get("u", (maxiter, S - n_el, n_el)),
                          self._get("z", (maxiter, S - n_el, M + 1)))

    def inner_exact(self, S: int, M: int, n_el: int, maxiter: int
                    ) -> ExactInnerDraws:
        return ExactInnerDraws(self._get("samples0", (S, M + 1)),
                               self._get("z_exact", (maxiter, S - n_el, M + 1)))

    def keys(self, seeds: Sequence[int], iterations: int) -> torch.Tensor:
        """(N, iterations, 2) int64: each scenario's (idx_mpc, it)."""
        return _seed_table(seeds, iterations)

    def rollout_eps(self, keys: torch.Tensor, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        it = keys[:, 1]
        return tuple(self.arrays[n][it] for n in
                     ("eps_acc", "eps_steer", "eps_const"))

    def rollout_beta(self, keys: torch.Tensor, R: int, alpha: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
        """Beta draws (2, N, C, R, T) for the parameters (2, N, C, T)."""
        _, N, C, T = alpha.shape
        shape = (2, N, C, R, T)
        if "beta" in self.arrays:
            draws = self.arrays["beta"][keys[:, 1]].transpose(0, 1)
        elif self.beta_fn is not None:
            if self.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise ValueError("FixedNoise's beta_fn draws on the host, which a "
                                 "CUDA graph cannot capture: pass graph=False")
            draws = torch.stack([torch.as_tensor(np.array(self.beta_fn(
                idx, it, R, alpha[:, i].cpu().numpy(), beta[:, i].cpu().numpy()),
                np.float32), device=self.device)
                for i, (idx, it) in enumerate(keys.tolist())], dim=1)
        else:
            raise ValueError("Beta noise needs arrays['beta'] or a beta_fn")
        if tuple(draws.shape) != shape:
            raise ValueError(f"beta: have {tuple(draws.shape)}, need {shape}")
        return draws

    def cem_z(self, keys: torch.Tensor, n: int, n_params: int) -> torch.Tensor:
        return self.arrays["cem_z"][keys[:, 1]]

    def init_key(self, idx_mpc: int) -> torch.Tensor:
        return torch.tensor([int(idx_mpc)], dtype=torch.int64)

    def init_state_z(self, key: torch.Tensor, n: int) -> torch.Tensor:
        return self._get("init_state_z", (n, 4))

    def gmm_init_draws(self, idx_mpc: int, n: int, probs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._get("gmm_z", (n, 4)),
                self._get("gmm_modes", (n,)).to(torch.int64))

    def mc_draws(self, seed: int, rows, n_mc: int, T: int, params=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        idx = torch.as_tensor(list(rows), dtype=torch.long, device=self.device)
        want = (len(idx), n_mc, T)
        eps = self.arrays["mc_eps_const"][idx]
        if params is None:
            d_acc = self.arrays["mc_eps_acc"][idx]
            d_steer = self.arrays["mc_eps_steer"][idx]
        else:
            beta = self.arrays["mc_beta"][idx]
            d_acc, d_steer = beta[:, 0], beta[:, 1]
        for name, d in (("d_acc", d_acc), ("d_steer", d_steer), ("eps_const", eps)):
            if tuple(d.shape) != want:
                raise ValueError(f"mc {name}: have {tuple(d.shape)}, need {want}")
        return d_acc, d_steer, eps


def record_solve_draws(source, cfg, idx_mpc: int) -> Tuple[Dict[str, np.ndarray], BetaFn]:
    """The draws one solve of ``cfg`` asks ``source`` for, as
    :class:`FixedNoise` arrays, and a ``beta_fn`` that draws the Beta noise
    from ``source`` and records it in those arrays as ``"beta"``.

    A first solve on ``FixedNoise(arrays, device, beta_fn)`` records; a
    solve on ``FixedNoise(arrays, other_device)`` made after it replays
    every draw, Beta included, so two devices can be held to one another.
    The arrays also hold the Frenet solve's ``init_state_z`` and, under
    the exact strategy, ``z_exact``.
    """
    c, bc = cfg.cem, cfg.beta_cem
    R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
    inner_args = (bc.num_samples_cem, cfg.risk.num_mother, bc.num_ellite,
                  bc.maxiter)
    inner = source.inner_cem(*inner_args)
    table = source.keys([idx_mpc], c.maxiter_cem)
    eps = [source.rollout_eps(table[:, it], R, T) for it in range(c.maxiter_cem)]
    arrays = {"initial_z": source.initial_z(c.num_batch, c.num_params),
              "init_state_z": source.init_state_z(source.init_key(idx_mpc),
                                                  init_state_count(cfg)),
              "samples0": inner.samples0, "u": inner.u, "z": inner.z,
              "eps_acc": torch.cat([e[0] for e in eps]),
              "eps_steer": torch.cat([e[1] for e in eps]),
              "eps_const": torch.cat([e[2] for e in eps]),
              "cem_z": torch.cat([source.cem_z(table[:, it],
                                               c.num_batch - c.ellite_num,
                                               c.num_params)
                                  for it in range(c.maxiter_cem)])}
    if cfg.solve_strategy == "exact":
        arrays["z_exact"] = source.inner_exact(*inner_args).z
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    drawn = []

    def beta_fn(idx, it, R, alpha, beta):
        as_t = lambda a: torch.as_tensor(a, device=source.device)[:, None]
        d = source.rollout_beta(source.keys([idx], it + 1)[:, it], R, as_t(alpha),
                                as_t(beta))[:, 0]
        drawn.append(d.cpu().numpy())
        arrays["beta"] = np.stack(drawn)
        return drawn[-1]

    return arrays, beta_fn
