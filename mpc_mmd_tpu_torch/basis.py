"""Bernstein polynomial basis, evaluated in float64 numpy on the host.

Same recurrence as ``mpc_mmd_tpu/basis.py``: the basis matrices are setup-time
constants, so they are computed once in float64 and handed to the device as
float32 tensors by :func:`mpc_mmd_tpu_torch.qp.build_workspace`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
from scipy.special import binom


class BernsteinBasis(NamedTuple):
    """P, Pdot, Pddot: (num, order+1) positions and time derivatives."""

    P: np.ndarray
    Pdot: np.ndarray
    Pddot: np.ndarray

    @property
    def nvar(self) -> int:
        return self.P.shape[1]


def _bernstein_matrix(order: int, s: np.ndarray) -> np.ndarray:
    k = np.arange(order + 1)
    with np.errstate(invalid="ignore"):
        out = binom(order, k)[None, :] * (s[:, None] ** k[None, :]) * (
            (1.0 - s[:, None]) ** (order - k)[None, :]
        )
    return np.nan_to_num(out)


def bernstein_basis(order: int, tmin: float, tmax: float,
                    t: np.ndarray) -> BernsteinBasis:
    """Basis and derivatives at times ``t`` within [tmin, tmax]."""
    t = np.asarray(t, dtype=np.float64).reshape(-1)
    length = float(tmax) - float(tmin)
    s = (t - float(tmin)) / length

    P = _bernstein_matrix(order, s)

    Pm1 = _bernstein_matrix(order - 1, s)
    D1 = np.zeros_like(P)
    D1[:, 1:] += order * Pm1
    D1[:, :-1] -= order * Pm1

    Pm2 = _bernstein_matrix(order - 2, s)
    D2 = np.zeros_like(P)
    c = order * (order - 1)
    D2[:, 2:] += c * Pm2
    D2[:, 1:-1] -= 2.0 * c * Pm2
    D2[:, :-2] += c * Pm2

    return BernsteinBasis(P=P, Pdot=D1 / length, Pddot=D2 / (length ** 2))


@lru_cache(maxsize=64)
def uniform_basis(order: int, t_fin: float, num: int) -> BernsteinBasis:
    """Basis over ``num`` uniform samples of [0, t_fin]."""
    t = np.linspace(0.0, t_fin, num)
    return bernstein_basis(order, t[0], t[-1], t)


def segment_slices(num: int, num_segments: int) -> Tuple[slice, ...]:
    """Equal split of the horizon rows into the guess QP's segments."""
    if num % num_segments != 0:
        raise ValueError(f"num={num} not divisible by num_segments={num_segments}")
    step = num // num_segments
    return tuple(slice(i * step, (i + 1) * step) for i in range(num_segments))
