"""Knapsack instances (the paper's running example, Eq. 1) + DP oracle.

The DD machinery (diagram.py / bnb.py) treats states generically; the
knapsack transition is the canonical separable CNP used throughout the
paper's Section I-A figures.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["Knapsack", "paper_example", "random_instance", "dp_solve"]


@dataclasses.dataclass(frozen=True)
class Knapsack:
    weights: Tuple[int, ...]
    profits: Tuple[int, ...]
    capacity: int

    @property
    def n(self) -> int:
        return len(self.weights)


def paper_example() -> Knapsack:
    """max 8x1+5x2+7x3+6x4  s.t. 3x1+2x2+4x3+6x4 <= 7 — optimum 15
    (Figure 2: x = (1, 0, 1, 0))."""
    return Knapsack(weights=(3, 2, 4, 6), profits=(8, 5, 7, 6), capacity=7)


def random_instance(n: int, seed: int = 0, max_w: int = 50,
                    max_p: int = 100, tightness: float = 0.5) -> Knapsack:
    rng = np.random.default_rng(seed)
    w = rng.integers(1, max_w + 1, n)
    p = rng.integers(1, max_p + 1, n)
    cap = max(int(w.sum() * tightness), int(w.max()))
    return Knapsack(weights=tuple(int(x) for x in w),
                    profits=tuple(int(x) for x in p), capacity=cap)


def dp_solve(inst: Knapsack) -> int:
    """Exact DP oracle, O(n * capacity)."""
    dp = np.zeros(inst.capacity + 1, dtype=np.int64)
    for w, p in zip(inst.weights, inst.profits):
        if w <= inst.capacity:
            dp[w:] = np.maximum(dp[w:], dp[:-w] + p)
    return int(dp.max())
