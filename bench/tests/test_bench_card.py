"""A short run of each cell on the card, through the command that
``BENCHMARK.json`` names: exit 0, a correct result line with every
metric the cell reports.  Needs a CUDA device (marked ``cuda``; it
decides inside the test, and skips on a machine without one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from _bench_tiny import BIG_SEED, ROOT
from bench.cell import load_cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["ks-uncorr-series", "ks-strong-series"])
def test_a_short_run_on_the_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         str(BIG_SEED), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in load_cell(name).metrics[trace]}
    assert set(line["metrics"]) == want
