"""``mfu.*``: the float32 operations that the counted kernels do in a
period (``roofline/``) over what the card's float32 peak does in the
period's mean wall time in the untraced window, in %."""

from portbench.harness.peaks import FP32_OPS_PER_S


def read(obs):
    ops = sum(o for _, o, _ in obs.kernel_bounds().values())
    if ops <= 0:
        return None
    return 100.0 * obs.per_period(ops) / (obs.mean_period_s * FP32_OPS_PER_S)
