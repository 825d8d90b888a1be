"""Kernel (f), the refit of the mother rollouts and their distance
matrices before the inner CEM, one launch an outer iteration in
``mmd_opt`` (``ops.inner_prologue``, ``inner_prologue_kernel``).

Bytes: the rollouts x, y, the basis rows P' and the refit inverse read
once; the coefficients cx, cy and D (and D2 where the kernel is not
laplace) written once.  Operations: the two products' multiply-adds count
two; a difference, an absolute value and an add a feature of every entry
of D, five a feature of D2."""

SYMBOL = "inner_prologue_kernel"
WRAPPER = "inner_prologue"


def count(cfg, chunk: int, frenet: bool):
    B, M = chunk * cfg.cem.num_batch, cfg.risk.num_reduced ** 2
    T, nvar = cfg.horizon.num_prime, cfg.horizon.nvar
    F = 2 * nvar
    d2 = cfg.risk.kernel != "laplace"
    floats = 2 * B * M * T + T * nvar + nvar * nvar + 2 * B * M * nvar + B * M * M * (1 + d2)
    ops = 2 * 2 * B * M * (T * nvar + nvar * nvar) + 3 * F * B * M * M + d2 * 5 * F * B * M * M
    return 4 * floats, ops, 0
