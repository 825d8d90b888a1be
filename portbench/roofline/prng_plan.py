"""Kernel (a)'s plan form: every Gaussian draw of a solve (or chunk) in one
launch at the head of the solve (``ops.prng_plan``, ``plan_kernel``).

Bytes: each key (16 bytes) read once, each normal written once.
Operations: 73 integer operations a draw (threefry-2x32's hash) and 50
float32 ones (the uniform and the erfinv polynomial)."""

SYMBOL = "plan_kernel"
WRAPPER = "prng_plan"
HASH_OPS, NORMAL_OPS = 73, 50


def count(cfg, chunk: int, frenet: bool):
    c, outer = cfg.cem, cfg.cem.maxiter_cem
    mode = cfg.risk.mode
    R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
    total = outer * chunk * (c.num_batch - c.ellite_num) * c.num_params
    keys = outer * chunk
    if mode != "det":
        total += 3 * outer * chunk * R * T
        keys += 3 * outer * chunk
    if frenet:
        n_init = {"mmd_opt": R * R, "det": 1}.get(mode, R)
        total += 4 * n_init
        keys += 1
    return 16 * keys + 4 * total, NORMAL_OPS * total, HASH_OPS * total
