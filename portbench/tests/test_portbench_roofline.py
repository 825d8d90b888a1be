"""The kernel counts of ``roofline/`` give ``PERF.md`` §6's "bound us" at
the path shapes the cells launch, carried over from ``chip_smoke.py``'s
records: fastrt (chunk 1), its chunk of 8 (E8) and the on-road solve
(Path D).  Kernel (g)'s point form is counted by bytes alone (its search's
work depends on the data), so its bound is below §6's 0.26 us, which
counted the search a record's inputs made."""

import pytest

from conftest import CHECKOUT


def _bound_us(kernel, config, chunk):
    import json
    from portbench.harness.peaks import bound_s
    from portbench.harness.spec import Spec
    from portbench.reference.config import from_dict
    conf = json.loads((CHECKOUT / "portbench" / "configs" / f"{config}.json").read_text())
    mod = Spec().counts()[kernel]
    return 1e6 * bound_s(*mod.count(from_dict(conf["problem"]), chunk,
                                    conf["solver"] == "FrenetSolver"))


@pytest.mark.parametrize("kernel,config,chunk,perf_us", [
    ("inner_cem", "static_mmd_fastrt", 1, 1.98), ("inner_cem", "static_mmd_fastrt", 8, 15.84),
    ("inner_cem", "onroad_mmd", 1, 0.51),
    ("outer_project", "static_mmd_fastrt", 1, 0.12),
    ("outer_project", "static_mmd_fastrt", 8, 0.91), ("outer_project", "onroad_mmd", 1, 0.18),
    ("outer_tail", "static_mmd_fastrt", 1, 0.10), ("outer_tail", "static_mmd_fastrt", 8, 0.78),
    ("outer_tail", "onroad_mmd", 1, 0.07),
    ("noisy_rollout", "static_mmd_fastrt", 1, 0.77),
    ("noisy_rollout", "static_mmd_fastrt", 8, 6.19), ("noisy_rollout", "onroad_mmd", 1, 0.20),
    ("inner_prologue", "static_mmd_fastrt", 1, 1.70),
    ("inner_prologue", "static_mmd_fastrt", 8, 13.57),
    ("inner_prologue", "onroad_mmd", 1, 0.26),
    ("prng_plan", "static_mmd_fastrt", 1, 0.09), ("prng_plan", "static_mmd_fastrt", 8, 0.69),
    ("prng_plan", "onroad_mmd", 1, 0.12),
    ("frenet_states", "onroad_mmd", 1, 0.005), ("frenet_obstacles", "onroad_mmd", 1, 0.005),
    ("local_frame", "onroad_mmd", 1, 0.44),
])
def test_bound_reproduces_the_kernel_table(kernel, config, chunk, perf_us):
    got = _bound_us(kernel, config, chunk)
    # the table rounds to two places; the counts of (d) on the road add the
    # path's two arrays to the 100 rows the table lists (0.186 us)
    assert abs(got - perf_us) <= 0.005 + 0.01 * perf_us, got


def test_point_form_counts_bytes_alone():
    got = _bound_us("frenet_points", "onroad_mmd", 1)
    assert 0.09 < got < 0.26
    assert got == pytest.approx(4 * (4 * 20_000 + 5 * 600) / 3.35e12 * 1e6)


def test_every_count_file_names_a_kernel_and_a_launch_counter():
    from mpc_mmd_tpu_torch.ops import KERNELS
    from portbench.harness.spec import Spec
    wrappers = {fn.__name__ for fn in KERNELS}
    for name, mod in Spec().counts().items():
        assert mod.WRAPPER in wrappers, name
        assert mod.SYMBOL.endswith("_kernel"), name
