#!/usr/bin/env python3
"""The JAX package's results for ``chip_smoke.py``'s mesh phase (phase 9),
computed on the CPU — the integers the phase pins as ``PHASE9_EXPECT`` and
holds the port's one-lane-per-rank solver to.

Runs ``repro.core.dd.parallel.parallel_solve`` (the JAX package's vmapped
lanes, its default routing) on phase 9's instance and geometry and prints
one JSON object: the optimum, supersteps, subproblems explored, items
transferred, steals and the subproblems each worker explored.  Needs JAX,
so it runs here, not on the card::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mesh_pins.py

``--small`` runs the CPU rehearsal's size (``PHASE9_SMALL``) instead of
the card's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py``'s configuration (its constants only; it imports
    no framework at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pins(cfg: dict) -> dict:
    """The JAX package's ``parallel_solve`` on ``cfg`` (phase 9's
    ``solver`` part)."""
    from repro.core.dd.knapsack import random_instance
    from repro.core.dd.parallel import parallel_solve
    from repro.core.policy import StealPolicy

    inst = random_instance(cfg["n_items"], seed=cfg["seed"])
    opt, st = parallel_solve(
        inst, n_workers=cfg["n_workers"], explore_width=cfg["explore_width"],
        batch=cfg["batch"], capacity=cfg["capacity"],
        policy=StealPolicy(proportion=0.5, high_watermark=4,
                           low_watermark=0, max_steal=cfg["max_steal"]))
    return dict(optimum=opt, supersteps=st["supersteps"],
                explored=st["explored"], transferred=st["transferred"],
                steals=st["telemetry"]["steals"],
                per_worker_explored=st["per_worker_explored"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the CPU rehearsal's size (PHASE9_SMALL)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    smoke = _smoke()
    cfg = (smoke.PHASE9_SMALL if args.small else smoke.PHASE9)["solver"]
    t0 = time.perf_counter()
    out = pins(cfg)
    print(json.dumps({"jax": jax.__version__,
                      "config": "small" if args.small else "card",
                      "cpu_s": round(time.perf_counter() - t0, 1), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
