"""``solve_p50_ms``: the median over every call of the window of one
call's wall time (host clock, to ``torch.cuda.synchronize()``)."""

from portbench.harness.stats import percentile


def read(obs):
    return 1e3 * percentile(obs.periods, 50)
