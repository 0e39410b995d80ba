"""The plain optimum of a 0/1 knapsack, and the benchmark's control.

:func:`optimum` is the textbook dynamic program over capacities,
O(n * c) in int64 NumPy.  :func:`control_optimum` is the same program
with a broken guarantee: it decides on profits held to a coarser grid,
``p // 20`` (2 % of Pisinger's range R = 1000), and returns the full
profit of the set it chose, so its answers are feasible and within
``20 n`` of the optimum but not proven optimal: the approximation scheme
a solver could be tempted to trade its proof for.  The harness's
comparison has to call it wrong.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["optimum", "control_optimum", "CONTROL_PROFIT_STEP"]

CONTROL_PROFIT_STEP = 20


def optimum(weights: Sequence[int], profits: Sequence[int],
            capacity: int) -> int:
    """max sum(p_j x_j) subject to sum(w_j x_j) <= capacity, x in {0,1}."""
    best = np.zeros(int(capacity) + 1, dtype=np.int64)
    for w, p in zip(weights, profits):
        w = int(w)
        if w <= capacity:
            best[w:] = np.maximum(best[w:], best[:-w] + int(p))
    return int(best[-1])


def control_optimum(weights: Sequence[int], profits: Sequence[int],
                    capacity: int, step: int = CONTROL_PROFIT_STEP) -> int:
    """The profit of the set that the dynamic program picks on profits
    ``p // step``, counted at full resolution."""
    c = int(capacity)
    coarse = np.zeros(c + 1, dtype=np.int64)
    full = np.zeros(c + 1, dtype=np.int64)
    for w, p in zip(weights, profits):
        w = int(w)
        if w > c:
            continue
        take = coarse[:-w] + int(p) // step
        better = take > coarse[w:]
        full[w:] = np.where(better, full[:-w] + int(p), full[w:])
        coarse[w:] = np.where(better, take, coarse[w:])
    return int(full[-1])
