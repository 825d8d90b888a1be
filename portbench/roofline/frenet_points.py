"""Kernel (g), the on-road rollouts' Frenet coordinates, one launch an outer
iteration of an on-road solve (``ops.frenet_points``,
``frenet_points_kernel``, which kernel (g)'s obstacle form shares).

Bytes: the reduced rollouts' points x, y read once, s, l written once, and
the path's five arrays once.  Operations: the tile-pruned search's work
depends on the data (the tiles its bounds cannot rule out), so none are
counted: the bound is the bytes', a lower bound of the kernel's."""

SYMBOL = "frenet_points_kernel"
WRAPPER = "frenet_points"


def count(cfg, chunk: int, frenet: bool):
    points = chunk * cfg.cem.num_batch * cfg.risk.num_reduced * cfg.horizon.num_prime
    return 4 * (4 * points + 5 * cfg.frenet.num_path), 0, 0
