"""The one generator of the benchmark's traffic: the stream of instances
a cell's client submits, made from its workload's traffic parameters
(the pool's seed and size in whole series, the block within which a
seed reorders it, the warm-up instance), its configuration (class, n, R,
H) and ``--seed``, which orders each block."""

from __future__ import annotations

from typing import Iterator

from bench.reference import pisinger

__all__ = ["instances", "warm_instance"]

# The series whose draw gives the warm-up instance: far past any series
# of a pool, so the warm solve is never one of the window's.
WARM_CYCLE = 2 ** 31


def _kw(traffic: dict, config: dict) -> dict:
    if traffic["generator"] != "pisinger_series":
        raise ValueError(f"unknown generator {traffic['generator']!r}")
    return dict(kind=config["class"], n=int(config["n"]), r=int(config["R"]),
                H=int(config["H"]))


def instances(traffic: dict, config: dict, seed: int
              ) -> Iterator[pisinger.Instance]:
    """The closed loop's stream: pass after pass over the cell's pool,
    each block of ``traffic["block"]`` instances in an order drawn from
    ``seed``."""
    kw = _kw(traffic, config)
    return pisinger.stream(seed, pisinger.pool(
        traffic["pool_seed"], traffic["pool_cycles"], **kw),
        traffic["block"])


def warm_instance(traffic: dict, config: dict, seed: int
                  ) -> pisinger.Instance:
    """Instance ``traffic["warm_h"]`` of a series drawn apart from the
    pool."""
    for inst in pisinger.cycle(traffic["pool_seed"], WARM_CYCLE,
                               order="ascending", **_kw(traffic, config)):
        if inst.h == traffic["warm_h"]:
            return inst
    raise ValueError(f"warm_h {traffic['warm_h']} is not in the series")
