"""The control on the card, at each cell's own size: the reference in the
program's place with every stored value in bfloat16, on three seeds, comes
out not correct. Run on a machine with the card:

    python3 -m pytest benchmark/tests/test_bm_control.py -m cuda -s
"""
from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import faults

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cells' size")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(card, name, seed):
    cell = harness.find_cell(name)
    line = harness.run_cell(cell, seed, 1.0, False, card, time.perf_counter(),
                            wrap=faults.control(cell))
    print(json.dumps({"cell": name, "seed": seed, "control": line["checks"]}))
    assert line["correct"] is False
