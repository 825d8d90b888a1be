"""The single injection point for every random draw of the solve.

A torch generator cannot reproduce JAX's threefry bits, so the solve never
draws itself: it asks a noise source for standard-normal and Beta tensors,
and the shapes and sharing below are those of the JAX package's key chain.
Every multivariate-normal draw of the path is ``mean + z @ chol(cov).T``
(equal to ``jax.random.multivariate_normal`` of the same key for an
identity covariance), so standard-normal ``z`` is all a source supplies
there.

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

A chunk of scenarios (``Solver.solve_batch`` above ``scenario_chunk``
1) asks for the per-iteration families once per scenario, each keyed by
that scenario's ``idx_mpc``, and stacks them on a leading scenario axis
(:func:`chunk_rollout_eps`, :func:`chunk_rollout_beta`,
:func:`chunk_cem_z`), so a scenario meets the same draws in a chunk as
alone; the solver-fixed draws stay shared by every scenario.

Under the ``exact`` strategy the inner CEM asks for ``inner_exact``:
``samples0`` as above (the JAX package draws it from the same key with
the covariance ``init_cov_scale * I``) and ``z`` (maxiter, S-n_el, M+1),
the standard normals of the multivariate normal that each iteration draws
straight from its update key ``split(split(key)[0])[0]``
(reduced_set.py:289-291,315-317).

The Frenet solve (``solver_frenet.py``) asks first, once per solve, for
``init_state_z`` (n, 4): the standard normals of ``split(PRNGKey(idx_mpc))[0]``
behind its n noisy initial states (solver_frenet.py:52-64; the identity
covariance makes the multivariate normal equal to z).  n is
:func:`init_state_count`.  Its outer iterations draw from the keys above
(solver_frenet.py:149,164,256), so they ask for the same families.

The Monte-Carlo validator (``validate.py``) asks for ``mc_draws``: per
solve row r of a validation with seed s, the JAX package keys
``split(split(PRNGKey(s), S)[r], 3)`` (validate.py:45,127) and draws from
the three keys (n_mc, T) each: ``eps_acc`` and ``eps_steer``, standard
normal, or under Beta noise the acc and steer Beta draws instead, and
``eps_const``.  A source draws them per (seed, row), so a solve's draws
do not depend on how the validator chunks the solves, and every mode of a
comparison meets the same draws in the same row.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


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


def chunk_rollout_eps(noise, seeds: Sequence[int], it: int, R: int, T: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rollout_eps`` of every scenario of a chunk, each (N, R, T)."""
    eps = [noise.rollout_eps(int(s), it, R, T) for s in seeds]
    return tuple(torch.stack(e) for e in zip(*eps))


def chunk_rollout_beta(noise, seeds: Sequence[int], it: int, R: int,
                       alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``rollout_beta`` of every scenario of a chunk: parameters (2, N, C,
    T), draws (2, N, C, R, T), scenario i's from its own seed."""
    return torch.stack([noise.rollout_beta(int(s), it, R, alpha[:, i], beta[:, i])
                        for i, s in enumerate(seeds)], dim=1)


def chunk_cem_z(noise, seeds: Sequence[int], it: int, n: int, n_params: int
                ) -> torch.Tensor:
    """``cem_z`` of every scenario of a chunk, (N, n, n_params)."""
    return torch.stack([noise.cem_z(int(s), it, n, n_params) for s in seeds])


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
    """Production noise: draws on ``device`` from ``generator``.

    Each family of draws re-seeds the generator from a fixed tuple, so a
    solve is a function of its ``idx_mpc`` (as in the JAX package, whose
    outer keys are ``PRNGKey(3*idx_mpc + 5*it + 7)``), and the draws made
    once per solver come out the same for every solver.
    """

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

    def rollout_eps(self, idx_mpc: int, it: int, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._randn((2, idx_mpc, it), (R, T), (R, T), (R, T))

    def rollout_beta(self, idx_mpc: int, it: int, R: int, alpha: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
        """Beta draws (2, C, R, T) for parameters alpha, beta (2, C, T) of
        the (acc, steer) channels; R draws per candidate and step."""
        g = self._seed((4, idx_mpc, it))
        shape = (alpha.shape[0], alpha.shape[1], R, alpha.shape[2])
        return sample_beta(alpha[:, :, None].expand(shape),
                           beta[:, :, None].expand(shape), g)

    def cem_z(self, idx_mpc: int, it: int, n: int, n_params: int) -> torch.Tensor:
        return self._randn((3, idx_mpc, it), (n, n_params))[0]

    def init_state_z(self, idx_mpc: int, n: int) -> torch.Tensor:
        return self._randn((6, idx_mpc), (n, 4))[0]

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


BetaFn = Callable[[int, int, int, np.ndarray, np.ndarray], np.ndarray]


class FixedNoise:
    """Replays given arrays: the draws of one solve, for tests and checks.

    ``arrays`` holds ``initial_z`` (nb, 8), ``samples0``, ``u``, ``z`` (see
    :class:`InnerDraws`), under the exact strategy ``z_exact`` (see
    :class:`ExactInnerDraws`), and per outer iteration ``eps_acc``,
    ``eps_steer``, ``eps_const`` (maxiter_cem, R, T) and ``cem_z``
    (maxiter_cem, nb - ellite_num, 8), for a Frenet solve
    ``init_state_z`` (n, 4), and for ``sampling.gmm_noisy_init_state``
    ``gmm_z`` (n, 4) and ``gmm_modes`` (n,).  ``idx_mpc`` is ignored, so
    every scenario of a chunk meets the same draws.

    Beta draws come from ``arrays["beta"]`` (maxiter_cem, 2, C, R, T) if
    given, else from ``beta_fn(idx_mpc, it, R, alpha, beta)``, which gets
    the parameters (2, C, T) as numpy arrays and returns (2, C, R, T).

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

    def rollout_eps(self, idx_mpc: int, it: int, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return tuple(self.arrays[n][it] for n in
                     ("eps_acc", "eps_steer", "eps_const"))

    def rollout_beta(self, idx_mpc: int, it: int, R: int, alpha: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
        shape = (alpha.shape[0], alpha.shape[1], R, alpha.shape[2])
        if "beta" in self.arrays:
            draws = self.arrays["beta"][it]
        elif self.beta_fn is not None:
            draws = torch.as_tensor(np.array(self.beta_fn(
                idx_mpc, it, R, alpha.cpu().numpy(), beta.cpu().numpy()),
                np.float32), device=self.device)
        else:
            raise ValueError("Beta noise needs arrays['beta'] or a beta_fn")
        if tuple(draws.shape) != shape:
            raise ValueError(f"beta: have {tuple(draws.shape)}, need {shape}")
        return draws

    def cem_z(self, idx_mpc: int, it: int, n: int, n_params: int) -> torch.Tensor:
        return self.arrays["cem_z"][it]

    def init_state_z(self, idx_mpc: int, n: int) -> torch.Tensor:
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
    its = range(c.maxiter_cem)
    eps = [source.rollout_eps(idx_mpc, it, R, T) for it in its]
    arrays = {"initial_z": source.initial_z(c.num_batch, c.num_params),
              "init_state_z": source.init_state_z(idx_mpc, init_state_count(cfg)),
              "samples0": inner.samples0, "u": inner.u, "z": inner.z,
              "eps_acc": torch.stack([e[0] for e in eps]),
              "eps_steer": torch.stack([e[1] for e in eps]),
              "eps_const": torch.stack([e[2] for e in eps]),
              "cem_z": torch.stack([source.cem_z(idx_mpc, it,
                                                 c.num_batch - c.ellite_num,
                                                 c.num_params) for it in its])}
    if cfg.solve_strategy == "exact":
        arrays["z_exact"] = source.inner_exact(*inner_args).z
    arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
    drawn = []

    def beta_fn(idx, it, R, alpha, beta):
        d = source.rollout_beta(idx, it, R,
                                torch.as_tensor(alpha, device=source.device),
                                torch.as_tensor(beta, device=source.device))
        drawn.append(d.cpu().numpy())
        arrays["beta"] = np.stack(drawn)
        return drawn[-1]

    return arrays, beta_fn
