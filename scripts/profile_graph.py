#!/usr/bin/env python3
"""Where a benchmark cell's time goes on the replayed path: the untraced
solver, whose ``run_fused`` blocks replay one CUDA graph each
(``repro_torch.runtime.block_graph``), under ``torch.profiler`` with the
phase probe off (``bench/run.py --trace 1`` arms it, and so stays eager).

    python3 scripts/profile_graph.py --workload <cell> --seed <n> [--seconds 20] [--profile-seconds 10]

Sets up as ``bench/run.py`` does: the kernel library, the cell's
instances from ``--seed`` and one warm solve, whose second block captures
the graph.  Then two windows of closed-loop solves:
1. ``--seconds`` unprofiled: solves a second, supersteps a solve, and
   every solve's ``graph_captures`` / ``graph_replays`` /
   ``graph_eager_blocks`` summed (and the warm solve's apart);
2. ``--profile-seconds`` under the profiler with the program's host spans
   on: device busy and idle share of the window, device ms and idle ms a
   superstep, device operations a superstep, the top device operations
   (``bench/tracing.reduce_trace``), and the idle charged to the innermost
   host span (``bench/spans.reduce_spans``).
Prints one JSON line; run it on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
GRAPH = ("graph_captures", "graph_replays", "graph_eager_blocks")


def window(solve, stream, seconds: float, span=None) -> list:
    """Closed-loop solves for ``seconds``: each one's supersteps, graph
    counts and milliseconds."""
    import contextlib

    from repro_torch.core.dd.knapsack import Knapsack

    out, deadline = [], time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        inst = next(stream)
        t = time.perf_counter()
        with span() if span else contextlib.nullcontext():
            _, st = solve(Knapsack(inst.weights, inst.profits, inst.capacity))
        out.append({"ms": (time.perf_counter() - t) * 1e3,
                    "supersteps": st["supersteps"],
                    **{k: st[k] for k in GRAPH}})
    return out


def totals(solves: list) -> dict:
    return {k: sum(s[k] for s in solves) for k in ("supersteps", *GRAPH)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--profile-seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from bench.run import program_solver, use_checkout

    use_checkout(ROOT)
    import torch

    from bench import tracing, traffic
    from bench.cell import load_cell
    from bench.spans import reduce_spans, without_program_copies
    from repro_torch.core.dd.knapsack import Knapsack
    from repro_torch.kernels import _lib
    from repro_torch.obs import phase

    torch.set_num_threads(1)
    device = torch.device("cuda")
    cell = load_cell(args.workload, ROOT)
    _lib.library()
    solve = program_solver(cell.config, device)
    stream = traffic.instances(cell.traffic, cell.config, args.seed)
    warm = traffic.warm_instance(cell.traffic, cell.config, args.seed)
    _, warm_stats = solve(Knapsack(warm.weights, warm.profits, warm.capacity))
    torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    plain = window(solve, stream, args.seconds)
    torch.cuda.synchronize(device)
    plain_s = time.perf_counter() - t0

    rf = torch.profiler.record_function
    prev = phase.enable_spans(True)
    try:
        with tracing.profiled(True) as prof:
            with rf(tracing.WINDOW):
                t0 = time.perf_counter()
                profiled = window(solve, stream, args.profile_seconds,
                                  span=lambda: rf(tracing.SOLVE))
                torch.cuda.synchronize(device)
                profiled_s = time.perf_counter() - t0
    finally:
        phase.enable_spans(prev)
    from torch.autograd import DeviceType

    events = prof["events"]
    spans = reduce_spans(events, device_type=DeviceType.CUDA) or {}
    trace = tracing.reduce_trace(
        without_program_copies(events, DeviceType.CUDA)) or {}
    steps = totals(profiled)["supersteps"]
    busy = trace.get("busy_s")
    window_s = trace.get("window_trace_s")
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(device),
        "warm": {k: warm_stats[k] for k in ("supersteps", *GRAPH)},
        "plain": {"seconds": plain_s, "solves": len(plain),
                  "solves_per_s": len(plain) / plain_s, **totals(plain)},
        "profiled": {
            "seconds": profiled_s, "solves": len(profiled),
            **totals(profiled),
            "busy_s": busy, "window_s": window_s,
            "idle_share": busy and 1 - busy / window_s,
            "device_ms_per_superstep": busy and busy * 1e3 / steps,
            "idle_ms_per_superstep": busy and (window_s - busy) * 1e3 / steps,
            "ops_per_superstep": trace.get("device_ops", 0) / steps,
            "top_device_ops": trace.get("top_device_ops"),
            "idle_by_span": spans.get("idle_by_span", [])[:12],
            "spans": {k: v for k, v in (spans.get("spans") or {}).items()
                      if k in ("repro.replay", "repro.capture",
                               "repro.read_back", "repro.bookkeeping",
                               "repro.block", "repro.launch_runtime",
                               "repro.solve_end", "repro.solve")},
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
