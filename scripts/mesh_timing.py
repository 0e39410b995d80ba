#!/usr/bin/env python3
"""Where a superstep of the one-lane-per-process solver goes, on one card.

Runs ``chip_smoke.py`` phase 9's solver (``PHASE9["solver"]``: phase 3's
instance and geometry) with ``n`` workers, one lane per ``gloo`` rank,
for each ``n`` of ``--ranks`` — all ranks on the one card — and with the
same ``n`` lanes stacked in this process.  Each rank times every lane
collective (``core.lanes.MeshLanes``: the gathers, the lane max, the
all-to-all) on the host clock, from a device
synchronisation before it to its return, so that the time the card
spends on the rank's own kernels is not counted as the collective's.
Prints one JSON line per rank count: ms per superstep of the mesh (rank
0's, warm) and of the stacked run, the collectives per superstep, and
the share of the mesh's superstep spent inside them (rank 0's, and the
ranks' mean).  Run from the root of a checkout::

    python3 scripts/mesh_timing.py [--ranks 2 4 8] [--device cpu] [--small]

``--device cpu`` runs it on CPU ranks and ``--small`` at the CPU
rehearsal's size (``PHASE9_SMALL``): a rehearsal, whose times are the
host's, not the card's.  The timers synchronise the device around each
collective, so the mesh's ms per superstep here includes them (phase 9
reports it without).  The card's name and power limit lead the output.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402

TIMED = ("all_gather", "all_gather_tree", "max", "route")


def _timed_lanes(device):
    """Wrap ``MeshLanes``' collectives with host timers; returns the
    ``[calls, seconds]`` tally."""
    from repro_torch.core.lanes import MeshLanes

    tally, inside = [0, 0.0], [False]

    def wrap(fn):
        @functools.wraps(fn)
        def timed(self, *args, **kwargs):
            if inside[0]:  # all_gather_tree's own all_gather
                return fn(self, *args, **kwargs)
            inside[0] = True
            try:
                smoke.sync(device)
                t0 = time.perf_counter()
                out = fn(self, *args, **kwargs)
                smoke.sync(device)
            finally:
                inside[0] = False
            tally[0] += 1
            tally[1] += time.perf_counter() - t0
            return out
        return timed

    for name in TIMED:
        setattr(MeshLanes, name, wrap(getattr(MeshLanes, name)))
    return tally


def _rank(rank: int, cfg: dict, device_type: str) -> dict:
    from repro_torch.core.dd.knapsack import random_instance
    from repro_torch.core.dd.parallel import parallel_solve
    from repro_torch.core.policy import StealPolicy

    smoke._port()
    device = smoke._rank_device(rank, device_type)
    tally = _timed_lanes(device)
    inst = random_instance(cfg["n_items"], seed=cfg["seed"])
    policy = StealPolicy(proportion=0.5, high_watermark=4, low_watermark=0,
                         max_steal=cfg["max_steal"])

    def solve():
        return parallel_solve(
            inst, n_workers=cfg["n_workers"],
            explore_width=cfg["explore_width"], batch=cfg["batch"],
            capacity=cfg["capacity"], policy=policy, backend="cuda",
            execution="mesh", device=smoke._runtime_device(device, "mesh"))

    solve()  # warm up
    tally[:] = [0, 0.0]
    smoke.sync(device)
    t0 = time.perf_counter()
    _, st = solve()
    smoke.sync(device)
    wall = time.perf_counter() - t0
    calls, seconds = tally
    s = st["supersteps"]
    return {"ms_per_superstep": wall * 1e3 / s, "supersteps": s,
            "collectives_per_superstep": calls / s,
            "collective_ms_per_superstep": seconds * 1e3 / s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help="PHASE9_SMALL's solver (the CPU rehearsal's)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.launch.mesh import run_workers

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("mesh_timing: no CUDA device", file=sys.stderr)
            return 2
        print(smoke.card_line(), flush=True)
    lib, counters = smoke._port()
    device = torch.device(args.device)
    if args.device == "cuda":
        lib.library()
    for n in args.ranks:
        phase = smoke.PHASE9_SMALL if args.small else smoke.PHASE9
        cfg = dict(phase["solver"], n_workers=n)
        ranks = run_workers(functools.partial(_rank, cfg=cfg,
                                              device_type=args.device),
                            n, backend="gloo",
                            timeout=phase["timeout"])
        stacked = smoke.solve_counted(device, counters, cfg, "vmap")
        share = [r["collective_ms_per_superstep"] / r["ms_per_superstep"]
                 for r in ranks]
        print(json.dumps({
            "ranks": n, "device": args.device,
            "supersteps": stacked["supersteps"],
            "ms_per_superstep": {"mesh": ranks[0]["ms_per_superstep"],
                                 "stacked": stacked["ms_per_superstep"]},
            "collectives_per_superstep":
                ranks[0]["collectives_per_superstep"],
            "collective_ms_per_superstep":
                ranks[0]["collective_ms_per_superstep"],
            "collective_share": {"rank0": share[0],
                                 "mean": sum(share) / len(share)}}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
