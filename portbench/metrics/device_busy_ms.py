"""``device_busy_ms.*``: device busy time (the union of the card's kernel,
copy and set intervals) a period of the traced stretch, per solve."""


def read(obs):
    return 1e3 * obs.per_period(obs.session.busy_s()) / obs.units
