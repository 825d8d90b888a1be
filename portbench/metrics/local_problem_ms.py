"""``local_problem_ms.step``: the median over the window's steps of the
host time from the call of the program's ``local_problem`` to a
synchronise after it (measured in the ``--trace 1`` run's window)."""

from portbench.harness.stats import percentile


def read(obs):
    times = obs.host.get("local_problem_s") or []
    return 1e3 * percentile(times, 50) if times else None
