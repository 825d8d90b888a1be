"""The number that a cell's comparison with the reference reads."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping

import numpy as np


@contextlib.contextmanager
def tf32():
    """TF32 on for cuBLAS and cuDNN while the block runs: the precision below
    float32 with TF32 off, in which the control computes."""
    import torch
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def maybe_tf32(on: bool):
    return tf32() if on else contextlib.nullcontext()


def as_array(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def gap(program: Mapping, reference: Mapping) -> float:
    """The widest gap between the program's outputs and the reference's,
    field by field, each over the largest magnitude of the reference's
    field (plus 1e-6): 0 where they are equal, inf where the program gives a
    non-finite value that the reference does not or a field of another
    shape.  A NaN on both sides counts as equal."""
    worst = 0.0
    for name, ref in reference.items():
        r, p = as_array(ref), as_array(program[name])
        if r.shape != p.shape:
            return math.inf
        both = np.isnan(r) & np.isnan(p)
        d = np.where(both, 0.0, np.abs(p - r))
        if np.isnan(d).any() or (np.isinf(d).any()):
            return math.inf
        scale = float(np.nanmax(np.abs(np.where(both, 0.0, r)))) if r.size else 0.0
        worst = max(worst, float(d.max()) / (scale + 1e-6) if d.size else 0.0)
    return worst


def number(value: float, limit: float) -> dict:
    """A compared number beside its limit (``None`` where it is not finite)."""
    return {"value": value if math.isfinite(value) else None, "limit": limit}


JUMP = 1e-5
"""An ``it1_gap`` above this is a jump (a near-tie in the inner CEM picked
another reduced set for the best candidate), not round-off."""


def _rel(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    d = np.abs(p - r) / (np.abs(r) + 1e-6)
    return np.where(np.isfinite(d), d, np.inf)


def _norm_gap(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per scenario, the gap between the program's norm and the
    reference's, over the reference's: 1 where the program's is 0."""
    d = np.abs(p - r) / (np.abs(r) + 1e-12)
    return np.where(np.isfinite(d), d, np.inf)


def iteration_numbers(out: Mapping, ref: Mapping, mean_in, cov_in) -> Dict[str, np.ndarray]:
    """Per scenario (the leading axes of ``res``), the numbers of the outer
    loop that the comparison reads:

    * ``it1_gap``: the wider relative gap of the first outer iteration's
      best cost and its projection residual (``res[..., 0]``,
      ``res_2[..., 0]``, which the on-road solve does not return), which
      both sides reach from the same inputs;
      ``it1_jump`` 1 where it is above ``JUMP``, else 0;
    * ``axis``: 1 where the program's ``res``, ``res_2``, ``mean_param`` or
      ``cov_param`` has another shape than the reference's or a value that
      is not finite, else 0 (every iteration written, each a number);
    * ``move_gap`` / ``cov_gap``: the gap between the program's and the
      reference's distance of the final CEM mean (Euclidean) / covariance
      (Frobenius) from the solve's input, over the reference's: 1 where
      the program's update leaves its state unchanged;
    * ``last_gap``: the relative gap of the last iteration's best cost.

    Every number is inf where the program's value is not finite."""
    names = [n for n in ("res", "res_2", "mean_param", "cov_param") if n in ref]
    rp = {n: as_array(out[n]) for n in names}
    rr = {n: as_array(ref[n]) for n in names}
    lead = rr["res"].shape[:-1]
    if any(rp[n].shape != rr[n].shape for n in names):
        bad, one = np.full(lead, np.inf), np.ones(lead)
        return {k: np.atleast_1d(v) for k, v in dict(
            it1_gap=bad, it1_jump=one, axis=one, move_gap=bad, cov_gap=bad,
            last_gap=bad).items()}
    axis = np.zeros(lead)
    for n in names:
        finite = np.isfinite(rp[n]).reshape(*lead, -1).all(axis=-1)
        axis = np.maximum(axis, (~finite).astype(float))
    it1 = _rel(rp["res"][..., 0], rr["res"][..., 0])
    if "res_2" in rr:
        it1 = np.maximum(it1, _rel(rp["res_2"][..., 0], rr["res_2"][..., 0]))
    m0 = np.broadcast_to(as_array(mean_in), rr["mean_param"].shape)
    c0 = np.broadcast_to(as_array(cov_in), rr["cov_param"].shape)
    move = lambda m: np.linalg.norm(m - m0, axis=-1)
    spread = lambda c: np.linalg.norm((c - c0).reshape(*lead, -1), axis=-1)
    got = dict(
        it1_gap=it1, it1_jump=(it1 > JUMP).astype(float), axis=axis,
        move_gap=_norm_gap(move(rp["mean_param"]), move(rr["mean_param"])),
        cov_gap=_norm_gap(spread(rp["cov_param"]), spread(rr["cov_param"])),
        last_gap=_rel(rp["res"][..., -1], rr["res"][..., -1]))
    return {k: np.atleast_1d(v) for k, v in got.items()}


def raw(out: Mapping, ref: Mapping, mean_in, cov_in) -> dict:
    """What ``iteration_numbers`` reads, both sides, as lists (a record of
    the readings that limits are set from)."""
    pick = lambda d: {n: as_array(d[n]).tolist() for n in ("res", "res_2", "mean_param",
                                                          "cov_param") if n in ref}
    return {"program": pick(out), "reference": pick(ref),
            "mean_in": as_array(mean_in).tolist(), "cov_in": as_array(cov_in).tolist()}


def numbers(out: Mapping, ref: Mapping, mean_in, cov_in) -> Dict[str, List[float]]:
    """What the comparison of one answer (a solve, or a chunk's scenarios)
    with the reference's reads, as lists over its scenarios (see
    ``iteration_numbers``), and ``out_gap``, the widest gap of every output
    of the answer (read, not compared: near-ties in the inner CEM move the
    later iterations of single answers)."""
    got = {k: list(v) for k, v in iteration_numbers(out, ref, mean_in, cov_in).items()}
    got["out_gap"] = [gap(out, ref)]
    return got


def collect(into: Dict[str, List[float]], got: Dict[str, List[float]]) -> None:
    for name, values in got.items():
        into.setdefault(name, []).extend(float(v) for v in values)


def reduce(values: Dict[str, List[float]], limits: Dict[str, float]) -> Dict[str, dict]:
    """The compared numbers that ``limits`` names, each beside its limit:
    ``<name>_med`` the median of ``<name>``'s readings over the compared
    answers, ``<name>_q25`` their first quartile (numpy's), ``<name>_mean``
    their mean (of ``it1_jump``: the share of jumps), ``<name>`` their
    largest.  A number with no readings is inf: nothing was compared."""
    out = {}
    for key, limit in limits.items():
        base, _, stat = key.rpartition("_")
        if stat not in STATS:
            base, stat = key, "max"
        v = values.get(base, [])
        with np.errstate(invalid="ignore"):      # inf - inf between two gaps that are inf
            value = float(STATS[stat](np.asarray(v, float))) if v else math.inf
        out[key] = number(value if not math.isnan(value) else math.inf, limit)
    return out


STATS = {"med": lambda v: np.quantile(v, 0.5), "q25": lambda v: np.quantile(v, 0.25),
         "mean": np.mean, "max": np.max}
