"""Which chunk sizes give a scenario the bits it has alone, family by family.

    python -m mpc_mmd_tpu_torch.utils.chunk_bits [--up_to 64] [--out FILE]

A chunk of scenarios (``Solver(..., scenario_chunk=n)``) equals its
scenarios solved alone bit for bit only if every call whose rows grow
with the chunk gives a scenario's rows the bits they have in a call of
their own.  A library picks its kernel, and with it the order of a row's
sums, by the shape of the whole call, so that is a property of the card
and the library, checked here at the shapes the solves give each family:

* ``scenario_mm``: the shared-weight products of the guess QP, the
  projection and the refit (``linalg.scenario_mm``), (rows of one
  scenario, K, N);
* ``cholesky``: the outer CEM's factors of the scenarios' 8 x 8
  covariances (``sampling._cholesky``);
* ``resample``: the inner CEM's ``A_t @ elites`` over every candidate of
  the chunk (``reduced_set.py``'s ``update``), (S', n_el, M + 1,
  candidates a scenario);
* ``pairwise_l2sq``: the squared distances of the refitted features
  (``kernels.pairwise_l2sq``, gaussian and matern52 kernels), (M,
  candidates a scenario).

:func:`failing_counts` returns the counts at which some scenario's rows
differ from that scenario alone; ``tests/test_torch_gpu.py`` holds each
family to none at the counts it lists.  Run as a script on the card, it
tries every count from 1 to ``--up_to`` at every shape and prints one
JSON line: per family and shape, the counts that failed.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..kernels import pairwise_l2sq
from ..linalg import scenario_mm
from ..sampling import _cholesky

# (rows of one scenario, K, N): the guess QP, the projection and its KKT
# solves at 64 (fastrt) and 100 (dynamic, on-road) candidates, and the
# refit of the mother rollouts
SCENARIO_MM = [(R, K, N) for R in (64, 100) for K, N in (
    (4, 11), (11, 100), (11, 198), (14, 14), (15, 15), (100, 11), (198, 11))] + [
    (6400, 50, 11), (6400, 11, 11), (10000, 50, 11), (10000, 11, 11),
    (1600, 50, 11), (1600, 11, 11)]
# (S', n_el, M + 1, candidates a scenario): fastrt, dynamic, on-road
RESAMPLE = [(57, 7, 101, 64), (89, 11, 101, 100), (89, 11, 17, 100)]
# (M, candidates a scenario)
PAIRWISE_L2SQ = [(100, 64), (100, 100), (16, 100)]
SHAPES = {"scenario_mm": SCENARIO_MM, "cholesky": [(8,)], "resample": RESAMPLE,
          "pairwise_l2sq": PAIRWISE_L2SQ}


def _call(family: str, shape, most: int, gen: torch.Generator):
    """fn(lo, n): the family's call over scenarios lo ... lo + n - 1 of
    inputs made for ``most``, split per scenario (n, ...)."""
    dev = gen.device
    randn = lambda *s: torch.randn(s, device=dev, generator=gen)
    if family == "scenario_mm":
        rows, K, N = shape
        w, x = randn(K, N), randn(most * rows, K)
        return lambda lo, n: scenario_mm(x[lo * rows:(lo + n) * rows], w,
                                         n).view(n, rows, N)
    if family == "cholesky":
        L = randn(most, 8, 8)
        A = L @ L.mT + 0.1 * torch.eye(8, device=dev)
        return lambda lo, n: _cholesky(A[lo:lo + n])
    if family == "resample":
        S, n_el, M1, nb = shape
        A, E = randn(S, n_el), randn(most * nb, n_el, M1)
        return lambda lo, n: (A @ E[lo * nb:(lo + n) * nb]).view(
            n, nb, S, M1)
    if family == "pairwise_l2sq":
        M, nb = shape
        F = randn(most * nb, M, 22)
        return lambda lo, n: pairwise_l2sq(F[lo * nb:(lo + n) * nb],
                                           F[lo * nb:(lo + n) * nb]).view(n, nb, M, M)
    raise ValueError(f"unknown family {family!r}")


def failing_counts(family: str, shape, counts, gen: torch.Generator) -> list:
    """The counts n of ``counts`` at which some scenario of a call over n
    scenarios does not have, bit for bit, the output it has in a call of
    its own (NaN equal to NaN)."""
    most = max(counts)
    fn = _call(family, shape, most, gen)
    alone = torch.cat([fn(i, 1) for i in range(most)])
    bad = []
    for n in counts:
        out, ref = fn(0, n), alone[:n]
        if not bool(((out == ref) | (out.isnan() & ref.isnan())).all()):
            bad.append(n)
    return bad


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--up_to", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON line here")
    args = p.parse_args(argv)
    gen = torch.Generator(device=args.device).manual_seed(0)
    counts = list(range(1, args.up_to + 1))
    t0 = time.perf_counter()
    result = {"device": (torch.cuda.get_device_name(0) if args.device != "cpu"
                         else "cpu"), "torch": torch.__version__, "counts": [1, args.up_to],
              "failing": {f: {"x".join(map(str, s)): failing_counts(f, s, counts, gen)
                              for s in shapes} for f, shapes in SHAPES.items()}}
    result["s"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
