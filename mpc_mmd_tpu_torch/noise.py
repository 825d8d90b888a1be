"""The single injection point for every random draw of the solve.

A torch generator cannot reproduce JAX's threefry bits, so the solve never
draws itself: it asks a noise source for standard-normal tensors, and the
shapes and sharing below are those of the JAX package's key chain.  Every
multivariate-normal draw of the path is ``mean + z @ chol(cov).T`` (equal to
``jax.random.multivariate_normal`` of the same key for an identity
covariance), so standard-normal ``z`` is all a source supplies.

Draws and where the JAX package makes them:

* ``initial_z`` (nb, 8): the initial parameter batch.  The JAX package
  reuses ``split(PRNGKey(0))[0]`` for every solve (sampling.py:34-39), so
  a solver draws it once.
* ``inner_cem``: ``samples0`` (S, M+1), ``u`` (maxiter, S-n_el, n_el) and
  ``z`` (maxiter, S-n_el, M+1) of the inner beta-CEM, keyed from
  ``PRNGKey(0)`` (reduced_set.py:432-466) and so also drawn once.
* ``rollout_eps`` per outer iteration: ``eps_acc``, ``eps_steer`` and
  ``eps_const``, each (R, T), shared by all candidates (the JAX key is
  closed over in the vmap, solver.py:115-116, dynamics.py:91-120).
* ``cem_z`` per outer iteration: (nb - ellite_num, 8) for the resample of
  the outer CEM update (solver.py:299).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


class InnerDraws(NamedTuple):
    samples0: torch.Tensor      # (S, M+1) standard normal
    u: torch.Tensor             # (maxiter, S - n_el, n_el)
    z: torch.Tensor             # (maxiter, S - n_el, M + 1)


class TorchNoise:
    """Production noise: ``torch.randn`` on ``device`` from ``generator``.

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

    def _randn(self, seed: Tuple[int, ...], *shapes):
        self.generator.manual_seed(hash(seed) & (2 ** 63 - 1))
        return tuple(torch.randn(s, generator=self.generator,
                                 device=self.device) for s in shapes)

    def initial_z(self, nb: int, n_params: int) -> torch.Tensor:
        return self._randn((0,), (nb, n_params))[0]

    def inner_cem(self, S: int, M: int, n_el: int, maxiter: int) -> InnerDraws:
        return InnerDraws(*self._randn(
            (1,), (S, M + 1), (maxiter, S - n_el, n_el),
            (maxiter, S - n_el, M + 1)))

    def rollout_eps(self, idx_mpc: int, it: int, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._randn((2, idx_mpc, it), (R, T), (R, T), (R, T))

    def cem_z(self, idx_mpc: int, it: int, n: int, n_params: int) -> torch.Tensor:
        return self._randn((3, idx_mpc, it), (n, n_params))[0]


class FixedNoise:
    """Replays given arrays: the draws of one solve, for tests and checks.

    ``arrays`` holds ``initial_z`` (nb, 8), ``samples0``, ``u``, ``z`` (see
    :class:`InnerDraws`), and per outer iteration ``eps_acc``,
    ``eps_steer``, ``eps_const`` (maxiter_cem, R, T) and ``cem_z``
    (maxiter_cem, nb - ellite_num, 8).  ``idx_mpc`` is ignored.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], device):
        self.device = torch.device(device)
        self.arrays = {k: torch.as_tensor(np.array(v, np.float32),
                                          device=self.device)
                       for k, v in arrays.items()}

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

    def rollout_eps(self, idx_mpc: int, it: int, R: int, T: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return tuple(self.arrays[n][it] for n in
                     ("eps_acc", "eps_steer", "eps_const"))

    def cem_z(self, idx_mpc: int, it: int, n: int, n_params: int) -> torch.Tensor:
        return self.arrays["cem_z"][it]
