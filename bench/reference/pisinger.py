"""Pisinger's knapsack instance classes and capacity series.

D. Pisinger, "Where are the hard knapsack problems?", Computers &
Operations Research 32(9), 2005, section 3: with data range R,

- class 1, uncorrelated: w_j and p_j uniform in [1, R];
- class 3, strongly correlated: w_j uniform in [1, R], p_j = w_j + R/10.

A series has H instances; instance h (1..H) has capacity
c = floor(h * sum(w) / (H + 1)), and each draws its own items.

A cell's instances are a pool of whole series (:func:`pool`), drawn from
a seed of the cell's own, so that every run's window holds the same work.
A run's ``--seed`` orders it: the stream (:func:`stream`) is pass after
pass over the pool, in blocks of the pool's fixed order, each block in an
order drawn from (seed, pass).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import numpy as np

__all__ = ["CLASSES", "Instance", "draw_items", "series_capacity",
           "cycle", "pool", "stream"]

CLASSES = ("uncorrelated", "strong")


class Instance(NamedTuple):
    h: int                      # the instance's number in its series
    weights: Tuple[int, ...]
    profits: Tuple[int, ...]
    capacity: int


def draw_items(rng: np.random.Generator, kind: str, n: int, r: int,
               count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` item sets of ``n`` items of class ``kind``: int64
    ``(count, n)`` weights and profits."""
    w = rng.integers(1, r + 1, size=(count, n), dtype=np.int64)
    if kind == "uncorrelated":
        p = rng.integers(1, r + 1, size=(count, n), dtype=np.int64)
    elif kind == "strong":
        p = w + r // 10
    else:
        raise ValueError(f"unknown class {kind!r}; expected one of "
                         f"{CLASSES}")
    return w, p


def series_capacity(h, weights_sum, H: int):
    """Capacity of instance ``h`` of a series of ``H``:
    floor(h * sum(w) / (H + 1))."""
    return (np.asarray(h, np.int64) * np.asarray(weights_sum, np.int64)
            ) // (H + 1)


def cycle(seed: int, k: int, *, kind: str, n: int, r: int, H: int,
          order: str = "shuffled") -> list:
    """Series ``k`` drawn from ``seed``: instances h = 1..H, each with
    its own items, in an order drawn from (seed, k)
    (``order="shuffled"``) or in order (``"ascending"``)."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, int(k)])
    w, p = draw_items(rng, kind, n, r, H)
    hs = np.arange(1, H + 1)
    if order == "shuffled":
        hs = rng.permutation(hs)
    elif order != "ascending":
        raise ValueError(f"unknown order {order!r}")
    caps = series_capacity(hs, w.sum(1), H)
    return [Instance(int(h), tuple(map(int, w[i])), tuple(map(int, p[i])),
                     int(caps[i])) for i, h in enumerate(hs)]


# The stream of a pool's seed that orders the pool: far past any series
# number of a pool and the warm-up series'.
POOL_ORDER = 2 ** 32


def pool(pool_seed: int, cycles: int, **kw) -> list:
    """``cycles`` whole series drawn from ``pool_seed``, in one order
    drawn from it too, so that consecutive instances mix capacities."""
    insts = [inst for k in range(cycles)
             for inst in cycle(pool_seed, k, order="ascending", **kw)]
    rng = np.random.default_rng([int(pool_seed) % 2 ** 63, POOL_ORDER])
    return [insts[i] for i in rng.permutation(len(insts))]


def stream(seed: int, instances: list, block: int = 0
           ) -> Iterator[Instance]:
    """The endless stream of ``seed`` over ``instances``: pass after
    pass, each taking them in blocks of ``block`` consecutive ones (one
    block of all with 0), each block in an order drawn from (seed, pass).
    Every seed does the same blocks in turn, so a window that ends inside
    a pass has done the same work but for the order in its last block."""
    size = block or len(instances)
    k = 0
    while True:
        rng = np.random.default_rng([int(seed) % 2 ** 63, k])
        for b in range(0, len(instances), size):
            chunk = instances[b:b + size]
            for i in rng.permutation(len(chunk)):
                yield chunk[i]
        k += 1
