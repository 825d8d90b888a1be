"""K4n, the noisy controls formed inside the rollouts, one launch an outer
iteration (``ops.noisy_rollout``, ``noisy_rollout_kernel``).

Bytes: the candidates' controls, the draws (Gaussian: one row of R a
scenario; Beta: a row a candidate) and the initial state(s) read once;
the positions x, y of every lane written once.  Lanes: R^2 mother
rollouts a candidate in ``mmd_opt``, else R.  Operations: K4's 16 a
lane-step and 5 of the noise."""

SYMBOL = "noisy_rollout_kernel"
WRAPPER = "noisy_rollout"


def count(cfg, chunk: int, frenet: bool):
    R, T = cfg.risk.num_reduced, cfg.horizon.num_prime
    C = chunk * cfg.cem.num_batch
    n = R * R if cfg.risk.mode == "mmd_opt" else R
    draws = 3 * chunk * R * T if cfg.noise.kind == "gaussian" else 2 * C * R * T + chunk * R * T
    states = 5 * n if frenet else 5
    lanes = C * n
    return 4 * (2 * C * T + draws + states + 2 * lanes * T), 21 * lanes * T, 0
