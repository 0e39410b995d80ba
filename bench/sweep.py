#!/usr/bin/env python3
"""The sizing sweep of a cell on the card, in one process: at batch
``--batch``, n from ``--n`` in turn (smallest first, stopping once a
window would hold fewer than ``--target-solves`` solves in
``--run-seconds``), then at the largest n that holds them each batch of
``--batches``, untraced and, with ``--traced``, traced.  One JSON line a
point: solves a second, the p90, supersteps and items stolen a solve,
each lane's peak ring size and the rows a full ring refused (counted in
the untraced points, ``bench/rings.py``), the traced idle share.

    python3 bench/sweep.py --workload ks-uncorr-series --seed 7 --seconds 10
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import use_checkout  # noqa: E402


def point(cell, n, batch, seed, seconds, trace, dump=None):
    import torch

    from bench import rings
    from bench.run import run_cell
    from repro_torch.core.dd import parallel

    c = copy.copy(cell)
    c.config = copy.deepcopy(cell.config)
    c.config["n"], c.config["solver"]["batch"] = n, batch
    t = time.perf_counter()
    record = {}
    counting = (contextlib.nullcontext(None) if trace
                else rings.counted(parallel, torch))
    with counting as counter:
        line = run_cell(c, seed, seconds, trace, record_out=record,
                        t_start=t)
    if dump:
        with open(dump, "a") as f:
            f.write(json.dumps({"cell": cell.name, "n": n, "batch": batch,
                                "seed": seed, "trace": trace,
                                "solves": [[s["h"], s["ms"],
                                            s["supersteps"],
                                            s["transferred"]]
                                           for s in record["solves"]]})
                    + "\n")
    solves = record["solves"]
    out = {"cell": cell.name, "n": n, "batch": batch, "trace": trace,
           "correct": line["correct"], "attempted": line["attempted"],
           "failed": line["failed"],
           **{k: v["value"] for k, v in line["metrics"].items()},
           "supersteps_a_solve": sum(s["supersteps"] or 0 for s in solves)
           / max(len(solves), 1),
           "stolen_a_solve": sum(s["transferred"] or 0 for s in solves)
           / max(len(solves), 1)}
    if counter:
        out.update(counter.counts())
    if trace:
        out.update(line.get("counts", {}))
        out["busy_s"] = line["device"].get("busy_s")
        out["window_s"] = line["device"].get("window_s")
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--n", default="20,30,40,50")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--batches", default="8,32,128,512",
                    help="comma-separated; empty for none")
    ap.add_argument("--traced", action="store_true",
                    help="a traced point beside each untraced one of "
                    "--batches")
    ap.add_argument("--run-seconds", type=float, default=20)
    ap.add_argument("--target-solves", type=int, default=100)
    ap.add_argument("--dump", help="append every solve's h, ms, "
                    "supersteps and items stolen to this file, one line a "
                    "point")
    args = ap.parse_args()
    use_checkout()
    import torch

    from bench.cell import load_cell

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    chosen = None
    for n in map(int, args.n.split(",")):
        out = point(cell, n, args.batch, args.seed, args.seconds, 0,
                    args.dump)
        if out["solves_per_s"] * args.run_seconds < args.target_solves:
            break
        chosen = n
    if chosen is None:
        print(f"sweep: no n holds {args.target_solves} solves in "
              f"{args.run_seconds} s", file=sys.stderr)
        return 1
    print(json.dumps({"cell": cell.name, "chosen_n": chosen}), flush=True)
    for batch in [int(b) for b in args.batches.split(",") if b]:
        point(cell, chosen, batch, args.seed, args.seconds, 0, args.dump)
        if args.traced:
            point(cell, chosen, batch, args.seed, args.seconds, 1,
                  args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
