"""``kernels_roofline_pct.*``: the sum of the least times over the sum of
the device times of every port kernel that the traced stretch launched and
that a count file under ``roofline/`` names, in %."""


def read(obs):
    got = obs.kernel_bounds().values()
    device = sum(d for _, _, d in got)
    if device <= 0:
        return None
    return 100.0 * sum(b for b, _, _ in got) / device
