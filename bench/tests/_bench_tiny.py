"""A cell of the manifest cut to a size the CPU runs in a moment, for the
benchmark's CPU tests: 10 items, 4 lanes, batch 4, rings of 512."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench.cell import load_cell, load_kind  # noqa: E402

BIG_SEED = 2 ** 31 + 977
# the kind of every cell so far
KNAPSACK = load_kind("dd-knapsack")


def tiny_cell(name: str, n: int = 10):
    cell = load_cell(name)
    cell.config["n"] = n
    cell.config["solver"].update(n_workers=4, batch=4, capacity=512,
                                 max_supersteps=200)
    cell.config["solver"]["policy"]["max_steal"] = 256
    return cell


@pytest.fixture
def torch_threads():
    """``run_cell`` puts torch on one thread; give the test process its
    count back."""
    import torch

    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)
