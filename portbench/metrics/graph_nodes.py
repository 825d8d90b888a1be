"""``graph_nodes.*``: the nodes of the CUDA graph a period replays (the
solver's ``graph_stats()``), a count that repeats exactly."""


def read(obs):
    return obs.nodes
