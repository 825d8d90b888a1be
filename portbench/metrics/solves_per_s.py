"""``solves_per_s``: the scenarios solved in the window over the window's
seconds."""


def read(obs):
    return sum(obs.work) / obs.window_s
