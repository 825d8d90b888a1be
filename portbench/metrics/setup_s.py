"""``setup_s``: seconds from the start of the process to the first timed
call (imports, the kernels' library loaded or built, the solver, the
cell's inputs and the warm-up that captures its graph)."""


def read(obs):
    return obs.setup_s
