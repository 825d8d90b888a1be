"""The control on the card: the plain reference put in the program's place
and computed with TF32 on (the precision below the configurations'
float32 with TF32 off) comes out not correct in every cell, on three
seeds, at the cell's own size and a 20 s window (the closed loop's
compared steps have to reach the obstacles).  Needs the card: skips
without one."""

import json
import time

import pytest

from conftest import CHECKOUT

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in json.loads((CHECKOUT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not_correct(card, cell):
    from portbench.harness.cell import run_cell
    from portbench.harness.spec import Spec
    spec = Spec()
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        r = run_cell(spec, spec.cell(cell), seed, 20.0, False, card, time.perf_counter(),
                     lower=True)
        assert not r["correct"], (seed, r["compared"])
