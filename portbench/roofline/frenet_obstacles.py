"""Kernel (g)'s obstacle form, a closed-loop step's obstacles in Frenet
with their constant-velocity trajectories, one launch a step in
``closedloop.local_problem`` (``ops.frenet_obstacles``,
``frenet_points_kernel``).

Bytes: the obstacles' rows (5 floats) and the horizon's times read once,
their Frenet states (5 a obstacle) and trajectories written once, the
path's six arrays read once.  Operations: about 80 an obstacle (its frame,
kappa, the heading, vs, vl) and 4 a trajectory point; the search's work
depends on the data and is not counted."""

SYMBOL = "frenet_points_kernel"
WRAPPER = "frenet_obstacles"


def count(cfg, chunk: int, frenet: bool):
    m, num = cfg.obstacles.num_obs, cfg.horizon.num
    floats = 5 * m + num + 5 * m + 2 * m * num + 6 * cfg.frenet.num_path
    return 4 * floats, 80 * m + 4 * m * num, 0
