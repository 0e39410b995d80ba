#!/usr/bin/env python3
"""The queue path's kernels of one checkout, timed the way ``chip_smoke.py``
times them, for comparing two trees in one call on one card.

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and runs this checkout's ``chip_smoke.py`` code on it: phase 1's ring
kernel rows (K1-K4 at the solver's shapes, K1 and K4 also on the solver's
three-leaf payload), phase 2 (the backlog supersteps) and phase 3 (the DD
solver, checked against the JAX package's integers, with each kernel's
launches).  Prints one JSON line tagged with ``--label`` and the card.
To compare a parent commit with this one, unpack the parent into a
directory that ``.gitignore`` lists and run, in turns::

    python3 scripts/ring_timing.py --src <parent>/src --label parent
    python3 scripts/ring_timing.py --label change
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    if not torch.cuda.is_available():
        print("ring_timing: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.configs.paper_lfq import CONFIG

    lib, counters = smoke._port()  # the modules already imported from src
    device = torch.device("cuda")
    lib.library()
    rng = np.random.default_rng(0)
    timer = smoke.Timer(device)
    kernels = smoke.kernel_timings(device, rng, timer)
    for name, row in smoke.solver_payload_timings(device, rng,
                                                  timer).items():
        kernels[name]["solver_payload"] = row
    queue = smoke.phase_queue(device, lanes=smoke.LANES,
                              capacity=CONFIG.queue_capacity,
                              backlog=CONFIG.bench_initial_size,
                              max_steal=CONFIG.max_steal, rounds=8)
    solver = smoke.phase_solver(device, counters, expect=smoke.PHASE3_EXPECT,
                                **smoke.PHASE3)
    print(json.dumps({"label": args.label, "src": str(src),
                      "card": smoke.card_line(), "kernels": kernels,
                      "queue": queue, "solver": solver}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
