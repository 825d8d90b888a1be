"""``device_idle_pct.*``: the share of a period in which the card runs
nothing: 1 - (device busy time a period, the union of the card's kernel,
copy and set intervals in the traced stretch) / (the mean wall time of a
period in the untraced window), in %."""


def read(obs):
    busy = obs.per_period(obs.session.busy_s())
    return 100.0 * (1.0 - busy / obs.mean_period_s)
