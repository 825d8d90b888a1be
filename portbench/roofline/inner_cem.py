"""Kernel (c), the whole inner beta-CEM of a chunk's candidates, one launch
an outer iteration (``ops.inner_cem``, ``inner_cem_kernel``).

Bytes: the distance matrices D (and D2 where the kernel is not laplace),
the first batch, the resample's coefficients and normals and the lane
floor read once; beta, sigma, the residuals and the chosen indices (int64)
written once.  Operations: a division, an exp and an add per (row,
selected row, column), over the first batch and each later iteration's
fresh rows (elite-carry: the n_el elites are carried, not recomputed)."""

SYMBOL = "inner_cem_kernel"
WRAPPER = "inner_cem"


def count(cfg, chunk: int, frenet: bool):
    """(bytes, float32 operations, integer operations) of one launch."""
    b = cfg.beta_cem
    C, k = chunk * cfg.cem.num_batch, cfg.risk.num_reduced
    M, S, it, n_el = k * k, b.num_samples_cem, b.maxiter, b.num_ellite
    floats_in = (C * M * M * (1 if cfg.risk.kernel == "laplace" else 2) + S * (M + 1)
                 + it * (S - n_el) * n_el + it * (S - n_el) * (M + 1) + (M + 1))
    floats_out = C * k + C + C * it
    rows = S + (it - 1) * (S - n_el)
    return 4 * (floats_in + floats_out) + 8 * C * k, 3 * C * rows * k * M, 0
