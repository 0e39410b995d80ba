#!/usr/bin/env python3
"""The readings ``correct`` is decided from, at a cell's own size on the
card, in one process: for each seed a short window of the program as it
runs, of the control (``bench/reference/optimum.control_optimum`` in the
program's place) and of the program with each fault ``--faults`` names
(``bench/faults.py``) planted.  One JSON line a run, with the numbers
compared.

    python3 bench/control.py --workload ks-uncorr-series --seeds 1,2,3 --seconds 5 --faults half_batch,answer_altered
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import use_checkout  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--faults", default="",
                    help="comma-separated names of bench/faults.py")
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args()
    use_checkout()
    import torch

    from bench.cell import load_cell
    from bench.faults import plant
    from bench.reference.optimum import control_optimum
    from bench.run import run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    batch = cell.config["solver"]["batch"]

    def control(inst):
        return control_optimum(inst.weights, inst.profits, inst.capacity), \
            {"supersteps": 0, "transferred": 0}

    def report(seed, what, line):
        print(json.dumps({"cell": cell.name, "seed": seed, "what": what,
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "failed": line["failed"],
                          **{k: v["value"] for k, v in
                             line["checks"].items()}}), flush=True)

    for seed in map(int, args.seeds.split(",")):
        if not args.no_program:
            report(seed, "program", run_cell(cell, seed, args.seconds, 0,
                                             t_start=time.perf_counter()))
        report(seed, "control", run_cell(cell, seed, args.seconds, 0,
                                         solve=control,
                                         t_start=time.perf_counter()))
        for name in filter(None, args.faults.split(",")):
            with plant(name, batch):
                report(seed, name, run_cell(
                    cell, seed, args.seconds, 0,
                    max_solves=1 if name == "state_unchanged" else None,
                    t_start=time.perf_counter()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
