"""Kernel (e), an outer iteration's risk, ranking, cost and CEM update, one
launch an iteration (``ops.outer_tail``, ``outer_tail_kernel``).

Bytes: the rollouts, weights and bandwidths, the kept rows (7 of num), the
parameters, normals, moments and obstacles read once; the moments, the
parameters and the picks written once.  Operations: 8 a violation, an
MMD's R^2 kernel values (8 each) or CVaR's R^2 comparisons (3 each) a
candidate's reduction, 6 a lane violation, 30 a step of a kept candidate's
cost, and the update's products."""

SYMBOL = "outer_tail_kernel"
WRAPPER = "outer_tail"


def count(cfg, chunk: int, frenet: bool):
    c, mode = cfg.cem, cfg.risk.mode
    N, nb, R, T, num = chunk, c.num_batch, cfg.risk.num_reduced, cfg.horizon.num_prime, \
        cfg.horizon.num
    n_cost, nobs = min(c.ellite_num_cost, nb), cfg.obstacles.num_obs
    rolls = mode != "det"
    mmd = mode in ("mmd_opt", "mmd_random")
    lanes = rolls and (frenet or mode != "mmd_random")
    red = 8 * R * R if mmd else 3 * R * R if mode == "cvar" else R if rolls else 0
    nbytes = (4 * N * (rolls * 2 * nb * R * T + mmd * (nb * R + nb) + n_cost * 7 * num
                       + 2 * nb * 8 + 8 + 64 + rolls * 2 * nobs * T + 2 * nb + 2)
              + 4 * N * (8 + 64 + nb * 8 + 5))
    ops = N * (rolls * 8 * nb * R * nobs * T + red * (nb + lanes * 2 * n_cost)
               + lanes * 6 * n_cost * R * T + 30 * n_cost * num
               + 2 * (nb - c.ellite_num) * 64 + 4 * c.ellite_num * 64)
    return nbytes, ops, 0
