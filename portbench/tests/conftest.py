"""Shared fixtures of the benchmark's CPU tests: the benchmark's cells and
configurations cut to a size that runs in seconds on the CPU, as files of
their own under a temporary root that the harness searches first."""

import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

TINY = dict(cem=dict(num_batch=16, maxiter_cem=2), beta_cem=dict(num_samples_cem=16, maxiter=3),
            risk=dict(num_reduced=3))


def tiny_config(name: str) -> dict:
    conf = json.loads((CHECKOUT / "portbench" / "configs" / f"{name}.json").read_text())
    for group, values in TINY.items():
        conf["problem"][group].update(values)
    if conf["solver"] == "FrenetSolver":
        conf["problem"]["obstacles"]["num_obs"] = 2
    conf["name"] = f"tiny_{name}"
    return conf


@pytest.fixture
def tiny(tmp_path):
    """(Spec, benchmark dict): every cell also as ``tiny_<cell>`` on a tiny
    configuration ``tiny_<config>``, with its metrics."""
    from portbench.harness.spec import Spec
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    for kind in ("configs", "workloads"):
        (tmp_path / kind).mkdir()
    for c in bench["configs"]:
        (tmp_path / "configs" / f"tiny_{c['name']}.json").write_text(
            json.dumps(tiny_config(c["name"])))
    for w in list(bench["workloads"]):
        d = json.loads((CHECKOUT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        d["config"] = f"tiny_{d['config']}"
        d["params"].update(pool=8, warm=1, compare=2, traced_periods=2)
        (tmp_path / "workloads" / f"tiny_{w['name']}.json").write_text(json.dumps(d))
        bench["workloads"].append(dict(w, name=f"tiny_{w['name']}", config=f"tiny_{w['config']}"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [f"tiny_{x}" for x in m["workloads"]]
    return Spec([tmp_path], bench), bench


def run_tiny(spec, cell: str, seconds: float = 0.5, seed: int = 2 ** 31 + 77, driver=None):
    """One untraced run of ``cell`` on the CPU; its result."""
    import time
    import torch
    from portbench.harness.cell import run_cell
    return run_cell(spec, spec.cell(cell), seed, seconds, False, torch.device("cpu"),
                    time.perf_counter(), driver=driver)
