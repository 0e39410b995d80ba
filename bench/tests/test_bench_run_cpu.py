"""A rehearsal of a run on the CPU at a tiny instance: the solve loop, the
check and the assembly of the last line, through ``run_cell``.  The
measurement path itself refuses to run without a card
(``test_bench_manifest.test_refuses_without_a_card``)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _bench_tiny import BIG_SEED, ROOT, tiny_cell, torch_threads  # noqa: F401
from bench.run import run_cell

CELLS = ("ks-uncorr-series", "ks-strong-series")


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line(name, torch_threads):  # noqa: F811
    line = run_cell(tiny_cell(name), BIG_SEED, 1.0, 0, device="cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    assert set(line["metrics"]) == {"setup_s", "solves_per_s",
                                    "solve_ms_p90"}
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["metrics"]["solves_per_s"]["unit"] == "solves/s"
    assert line["device"]["platform"] == "cpu"
    assert line["checks"] == {k: {"value": 0, "limit": 0} for k in
                              ("raised", "unproven", "wrong_optimum")}
    json.dumps(line)


def test_traced_line(torch_threads):  # noqa: F811
    line = run_cell(tiny_cell("ks-strong-series"), BIG_SEED, 1.0, 1,
                    device="cpu")
    assert list(line)[-1] == "checks" and line["correct"] is True
    # the CPU has no device trace: the readers of device metrics find
    # nothing and the line leaves them out
    assert set(line["metrics"]) == {"supersteps_per_solve",
                                    "stolen_per_solve", "superstep_ms",
                                    "worker_body_ms", "exchange_ms"}
    counts = line["counts"]
    assert counts["explore_calls"] >= counts["rounds"] > 0
    assert counts["explore_ops"] > 0 and "ring_peak_rows" not in counts
    assert line["breakdown"]["device_ops"] == []
    assert line["metrics"]["supersteps_per_solve"]["value"] >= 1


def test_ring_counter_reads_each_push(torch_threads):  # noqa: F811
    import torch

    from bench import rings
    from repro_torch.core.dd import parallel

    make_body = parallel._make_worker_body
    cell = tiny_cell("ks-uncorr-series")
    with rings.counted(parallel, torch) as counter:
        line = run_cell(cell, BIG_SEED, 1.0, 0, device="cpu")
    assert parallel._make_worker_body is make_body
    counts = counter.counts()
    assert line["correct"] is True
    assert 0 < counts["ring_peak_rows"] <= cell.config["solver"]["capacity"]
    assert counts["ring_clamped_rows"] == 0
    # a ring too small for one push refuses rows, and the count sees them
    cell = tiny_cell("ks-uncorr-series", n=14)
    cell.config["solver"]["capacity"] = 4
    cell.config["solver"]["policy"]["max_steal"] = 4
    with rings.counted(parallel, torch) as counter:
        run_cell(cell, BIG_SEED, 1.0, 0, device="cpu", max_solves=2)
    assert counter.counts()["ring_clamped_rows"] > 0


def test_main_refuses_an_unknown_cell():
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and "correct" not in out.stdout
