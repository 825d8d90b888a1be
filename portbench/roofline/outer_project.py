"""Kernel (d), an outer iteration's guess QP, projection and controls, one
launch an iteration (``ops.outer_project``, ``outer_project_kernel``).

Bytes: each row's parameters, boundary rows, multipliers and lane slack
read once, the shared matrices (the segments' and KKT factors, the basis,
the lane rows), the path on the road and the obstacles in the
obstacle-active form once; each row's coefficients, controls, multipliers,
slack and residual written once.  Operations: a multiply-add counts two;
about 60 elementwise operations a step and round."""

SYMBOL = "outer_project_kernel"
WRAPPER = "outer_project"


def count(cfg, chunk: int, frenet: bool):
    h, it = cfg.horizon, cfg.projection.maxiter
    rows, nvar, num = chunk * cfg.cem.num_batch, h.nvar, h.num
    nl, nx, ny = 2 * (num - 1), nvar + 3, nvar + 4
    mats = (2 * cfg.guess.num_segments * nvar + 2 * (nx * nx + ny * ny) + 3 * num * nvar
            + nl * nvar)
    ops_row = (2 * nvar * (8 * num + it * (14 * num + 3 * nl)) + 2 * (nx * nx + ny * ny)
               * (it + 1) + 60 * num * (it + 1))
    path = 2 * cfg.frenet.num_path if frenet else 0
    obs = 0
    if cfg.projection.with_obstacle_terms:
        nblk = cfg.obstacles.num_obs * cfg.obstacles.num_circles
        obs = 2 * chunk * cfg.obstacles.num_obs * num
        ops_row += (it + 1) * (40 * nblk * num + 8 * nvar * num)
    floats = (rows * (8 + 7 + 2 * nvar + nl) + mats + path
              + rows * (4 * nvar + 10 * num + 1 + nl) + obs)
    return 4 * floats, rows * ops_row, 0
