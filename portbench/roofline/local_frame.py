"""Kernel (h), a closed-loop step's local path: the smoother's rounds and
the path parameters in one launch a step (``ops.local_frame``,
``local_frame_kernel``).

Bytes: the kept rows of the smoother's KKT inverse, m (m + 1) floats at m =
num_path, and the waypoints x, y read once; the six arrays of the frame
written once.  Operations: two multiply-adds a term a row a round, about
150 a row's update (atan2f, cosf, sinf), 50 a point's path parameters.
The smoother runs ``ROUNDS`` rounds (``frenet.build_smoother``'s
default, which the closed loop uses)."""

SYMBOL = "local_frame_kernel"
WRAPPER = "local_frame"
ROUNDS = 10


def count(cfg, chunk: int, frenet: bool):
    m = cfg.frenet.num_path
    floats = m * (m + 1) + 2 * m + 6 * m
    return 4 * floats, 4 * ROUNDS * m * (m + 1) + 150 * ROUNDS * m + 50 * m, 0
