"""The harness on the CPU at a tiny size: every cell runs and is correct,
a new cell, configuration, driver or metric is found by its file alone,
and each fault that a cell can have makes ``correct`` false."""

import json

import pytest

from conftest import run_tiny

CELLS = ["tiny_static_mmd_fastrt.solve", "tiny_onroad_mmd.closed_loop",
         "tiny_static_mmd_fastrt.sweep8"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs_and_matches_the_reference(tiny, cell):
    spec, bench = tiny
    r = run_tiny(spec, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0.0 for c in r["compared"].values()), r["compared"]
    e2e = {m["name"] for m in spec.metrics(cell, traced=False)}
    assert set(r["metrics"]) == e2e and "setup_s" in e2e and len(e2e) >= 2
    assert list(r)[-1] == "compared"


def test_a_new_cell_configuration_driver_and_metric_are_found_by_their_files(tiny, tmp_path):
    spec, bench = tiny
    root = spec.roots[0]
    (root / "traffic").mkdir()
    (root / "metrics").mkdir()
    conf = json.loads((root / "configs" / "tiny_static_mmd_fastrt.json").read_text())
    conf["problem"]["noise"]["level"] = 0.2
    (root / "configs" / "tiny_static_noisier.json").write_text(json.dumps(conf))
    (root / "workloads" / "tiny_static_noisier.burst.json").write_text(json.dumps(dict(
        config="tiny_static_noisier", driver="burst", why="a test's cell",
        params=dict(pool=4, warm=1, compare=1, traced_periods=1, limits=dict(out_gap=1e-3)))))
    # a driver of its own: solve_stream's, two calls a period
    (root / "traffic" / "burst.py").write_text(
        "from portbench.traffic.solve_stream import *\n"
        "from portbench.traffic import solve_stream as _s\n"
        "def period(s, traced=False):\n"
        "    return _s.period(s, traced) + _s.period(s, traced)\n")
    (root / "metrics" / "calls_per_period.py").write_text(
        "def read(obs):\n    return sum(obs.work) / len(obs.work)\n")
    bench["workloads"].append(dict(name="tiny_static_noisier.burst", config="tiny_static_noisier",
                                   traffic="burst", chips=1, why="a test's cell"))
    bench["end_to_end"].append(dict(name="calls_per_period", unit="calls", better="higher",
                                    bound=0.01, source="host_clock",
                                    workloads=["tiny_static_noisier.burst"]))
    r = run_tiny(spec, "tiny_static_noisier.burst")
    assert r["correct"], r["compared"]
    assert r["metrics"]["calls_per_period"]["value"] == 2.0
    assert set(r["metrics"]) == {"calls_per_period", "setup_s"}


FAULTS = [
    ("tiny_static_mmd_fastrt.solve", "altered_projection"),
    ("tiny_static_mmd_fastrt.solve", "unchanged_state"),
    ("tiny_static_mmd_fastrt.solve", "truncated_loop"),
    ("tiny_static_mmd_fastrt.solve", "minority_answers"),
    ("tiny_static_mmd_fastrt.sweep8", "altered_projection"),
    ("tiny_static_mmd_fastrt.sweep8", "half_left_out"),
    ("tiny_static_mmd_fastrt.sweep8", "unchanged_state"),
    ("tiny_static_mmd_fastrt.sweep8", "truncated_loop"),
    ("tiny_static_mmd_fastrt.sweep8", "minority_projection"),
    ("tiny_onroad_mmd.closed_loop", "altered_projection"),
    ("tiny_onroad_mmd.closed_loop", "unchanged_state"),
    ("tiny_onroad_mmd.closed_loop", "truncated_loop"),
    ("tiny_onroad_mmd.closed_loop", "altered_obstacles"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(tiny, monkeypatch, cell, fault):
    """The timed path broken underneath (the port's module or class,
    ``portbench/harness/faults.py``), the rest of a run as it is:
    ``correct`` comes out false."""
    from portbench.harness.faults import plant
    spec, _ = tiny
    seconds = 0.5
    if fault == "minority_answers":
        # three of every eight calls altered: compare every call of the window
        path = spec.roots[0] / "workloads" / f"{cell}.json"
        work = json.loads(path.read_text())
        work["params"]["compare"] = 10 ** 6
        path.write_text(json.dumps(work))
        seconds = 1.0
    plant(fault, monkeypatch.setattr)
    r = run_tiny(spec, cell, seconds=seconds)
    assert r["attempted"] >= 8 or fault != "minority_answers", r["attempted"]
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("broken", ["short", "nan"])
def test_an_iteration_axis_cut_short_or_not_finite_is_not_correct(broken):
    """``axis`` reads 1 where the program's per-iteration costs have another
    shape than the reference's or a value that is not a number, and every
    gap of that answer is then not finite."""
    import numpy as np
    from portbench.harness.compare import numbers, reduce
    rng = np.random.default_rng(0)
    ref = dict(res=rng.random(10) + 1, res_2=rng.random(10), mean_param=rng.random(8),
               cov_param=np.eye(8) * 2)
    out = {k: v.copy() for k, v in ref.items()}
    if broken == "short":
        out["res"] = out["res"][:1]
    else:
        out["res"][4] = np.nan
    got = numbers(out, ref, np.zeros(8), np.eye(8))
    assert got["axis"] == [1.0]
    compared = reduce(got, {"axis": 0.0, "last_gap_med": 1e-4})
    assert compared["axis"]["value"] == 1.0 > compared["axis"]["limit"]
    if broken == "short":
        assert compared["last_gap_med"]["value"] is None
