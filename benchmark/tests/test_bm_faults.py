"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have (faults.FAULTS; one card, so no exchange between
cards to leave out), on the CPU at a size a test run holds, the harness's
look for a card skipped."""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests import faults

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def small_run(name, wrap=None):
    cell = harness.find_cell(name, batch=2, pool=1, compare=1)
    return harness.run_cell(cell, 2**31 + 19, 0.0, False, "cpu",
                            time.perf_counter(),
                            wrap=None if wrap is None else wrap(cell))


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    line = small_run(name, faults.FAULTS[fault])
    assert line["correct"] is False
    assert line["failed"] >= 1


@pytest.mark.parametrize("name", [n for n in CELLS if ".sweep" in n])
def test_an_altered_codeword_is_caught_at_the_encoder(name):
    line = small_run(name, faults.encoded)
    assert line["correct"] is False
    assert line["checks"]["cw_bits_off"]["value"] >= 1


@pytest.mark.parametrize("name", [n for n in CELLS if ".sweep" in n])
def test_the_control_is_not_correct_in_the_sweep(name):
    # the bf16 channel moves the LLRs at any size; the decode cells'
    # control needs their full batches and runs on the card
    # (test_bm_control.py)
    line = small_run(name, faults.control)
    assert line["correct"] is False
    assert line["checks"]["llr_gap"]["value"] > line["checks"]["llr_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_path_is_correct(name):
    line = small_run(name)
    assert line["correct"] is True and line["failed"] == 0
