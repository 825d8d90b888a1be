"""``step_p95_ms``: the 95th percentile over every step of the window of a
closed-loop period, ``local_problem`` and the solve to
``torch.cuda.synchronize()`` (host clock)."""

from portbench.harness.stats import percentile


def read(obs):
    return 1e3 * percentile(obs.periods, 95)
