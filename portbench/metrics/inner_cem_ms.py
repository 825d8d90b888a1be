"""``inner_cem_ms.*``: kernel (c)'s device time a period of the traced
stretch, per solve.  Nothing where its launches are not one an outer
iteration a period."""

SYMBOL, WRAPPER = "inner_cem_kernel", "inner_cem"


def read(obs):
    s = obs.session
    if s.launches.get(WRAPPER, 0) != s.periods * obs.cfg.cem.maxiter_cem:
        return None
    return 1e3 * obs.per_period(s.kernel_s(SYMBOL)) / obs.units
