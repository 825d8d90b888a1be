"""``inner_cem_roofline_pct.*``: kernel (c)'s least time on the card
(``roofline/inner_cem.py`` against ``harness/peaks.py``) over its device
time in the traced stretch, in %."""


def read(obs):
    got = obs.kernel_bounds().get("inner_cem_kernel")
    if not got or got[2] <= 0:
        return None
    return 100.0 * got[0] / got[2]
