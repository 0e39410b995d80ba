"""The comparison that decides ``correct`` has to fail what is wrong: the
control (the reference with its guarantee broken, in the program's
place) and the timed path broken underneath in each way this cell's
solver can be (``bench/faults.py``), each driven through the rest of a
run on the CPU.  ``max_solves`` fixes the instances solved, so the
outcome does not hang on the host's speed."""

from __future__ import annotations

import pytest

from _bench_tiny import BIG_SEED, tiny_cell, torch_threads  # noqa: F401
from bench.faults import FAULTS
from bench.reference.optimum import control_optimum
from bench.run import run_cell

CELLS = ("ks-uncorr-series", "ks-strong-series")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault, monkeypatch,
                                      torch_threads):  # noqa: F811
    cell = tiny_cell(name, n=14)
    FAULTS[fault](monkeypatch.setattr, cell.config["solver"]["batch"])
    # a superstep that changes nothing runs to max_supersteps: one solve
    line = run_cell(cell, BIG_SEED, 120, 0, device="cpu",
                    max_solves=1 if fault == "state_unchanged" else 12)
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["wrong_optimum"]["value"] \
        + line["checks"]["unproven"]["value"] > 0


def test_a_sound_path_is_correct_on_the_same_instances(
        torch_threads):  # noqa: F811
    for name in CELLS:
        line = run_cell(tiny_cell(name, n=14), BIG_SEED, 120, 0,
                        device="cpu", max_solves=12)
        assert line["correct"] is True and line["attempted"] == 12


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, torch_threads):  # noqa: F811
    def control(inst):
        return control_optimum(inst.weights, inst.profits, inst.capacity), \
            {"supersteps": 0, "transferred": 0}

    line = run_cell(tiny_cell(name, n=20), BIG_SEED, 120, 0, device="cpu",
                    program=control, max_solves=100)
    assert line["correct"] is False
    assert line["checks"]["wrong_optimum"]["value"] > 0
    assert line["checks"]["raised"]["value"] == 0
    assert line["checks"]["unproven"]["value"] == 0
