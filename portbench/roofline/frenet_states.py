"""Kernel (g)'s state form, an on-road solve's noisy initial states with
their Frenet means and boundary rows, one launch a solve
(``ops.frenet_states``, ``frenet_states_kernel``).

Bytes: the normals (4 a state) and the initial state read once, the states
(5 a state) and the boundary rows b_eq_x (nb, 3), b_eq_y (nb, 4) written
once, the path's six arrays read once.  Operations: about 150 a state;
the search's work depends on the data and is not counted."""

SYMBOL = "frenet_states_kernel"
WRAPPER = "frenet_states"


def count(cfg, chunk: int, frenet: bool):
    R, mode = cfg.risk.num_reduced, cfg.risk.mode
    n = {"mmd_opt": R * R, "det": 1}.get(mode, R)
    floats = 4 * n + 6 + 5 * n + 7 * cfg.cem.num_batch + 6 * cfg.frenet.num_path
    return 4 * floats, 150 * n, 0
