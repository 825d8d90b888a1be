"""``step_p50_ms``: the median over every step of the window of a
closed-loop period (host clock)."""

from portbench.harness.stats import percentile


def read(obs):
    return 1e3 * percentile(obs.periods, 50)
