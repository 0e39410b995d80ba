#!/usr/bin/env python3
"""The program's own host spans (``repro.*``, ``repro_torch.obs.phase.
span``) in a traced run of a cell: where the host was, by program layer,
while the device waited.

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s> [--spans 0]

runs ``bench/run.py``'s traced run of the cell (``run_cell`` with
``--trace 1``) with the program's spans on for the warm solve and the
window (``--spans 0`` leaves them off: the same run as ``bench/run.py
--trace 1``, for the spans' cost).  Its last line is ``run_cell``'s line
with three keys more: ``spans`` (:func:`reduce_spans`: each span's count,
host seconds and self seconds, and the window's idle seconds charged to
the innermost span, ``repro.*`` or ``bench.*``, open where each idle gap
starts), ``span_metrics`` (:func:`span_metrics`) and ``ring`` (every
window solve's ``stats["ring_refused_rows"]`` and
``stats["ring_peak_rows"]``).

The profiler copies each ``record_function`` range onto the device's
timeline; ``bench/tracing.reduce_trace`` leaves out the device copies of
``bench.*`` spans only, so this run hands it the events without the
device copies of ``repro.*`` spans, and its outputs keep their meaning.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent))
from run import use_checkout  # noqa: E402

PROGRAM = "repro."
BENCH = "bench."
# an idle gap inside the window but in no span
NO_SPAN = "bench.between_solves"


def _sweep_innermost(spans, times) -> list:
    """For each of the ascending ``times``, the index into ``spans``
    (``(start, end, name)`` sorted by start, then longest first; properly
    nested, as context managers on one thread are) of the innermost span
    open at it, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and spans[stack[-1]][1] < spans[i][0]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _self_seconds(spans) -> list:
    """Each span's duration less its direct children's (``spans`` sorted
    by start, then longest first), in seconds."""
    child = [0] * len(spans)
    stack: list = []
    for i, (s, e, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] <= s \
                and spans[stack[-1]][0] != s:
            stack.pop()
        if stack:
            child[stack[-1]] += e - s
        stack.append(i)
    return [(e - s - c) / 1e9 for (s, e, _), c in zip(spans, child)]


def reduce_spans(events, *, device_type=None) -> Optional[dict]:
    """The window's host spans and idle time by span, from the raw
    profiler events of a traced window
    (``prof.profiler.kineto_results.events()``).

    ``spans``: for each ``repro.*`` name, its count, total host seconds
    and self seconds (less the ``repro.*`` spans directly inside it).
    ``idle_by_span``: the window's idle seconds (no device operation of
    the program running: the device copies of spans and the operations
    launched inside ``bench.instrument`` are not the program's) charged
    to the innermost span, of either family, open where each gap starts,
    largest first.  ``idle_s`` their sum and ``idle_in_program_s`` the
    part charged to ``repro.*`` spans.  None where the trace holds no
    window span."""
    from bench import tracing

    if device_type is None:
        from torch.autograd import DeviceType

        device_type = DeviceType.CUDA
    runtime_at: Dict[int, int] = {}
    launched_at: Dict[int, int] = {}
    host, device, window = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == device_type:
            if not name.startswith((BENCH, PROGRAM)):
                device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                               e.linked_correlation_id()))
        elif name.startswith("cu"):
            runtime_at[e.correlation_id()] = e.start_ns()
        elif e.linked_correlation_id() == 0:
            launched_at[e.correlation_id()] = e.start_ns()
            if name == tracing.WINDOW:
                window = (e.start_ns(), e.end_ns())
            elif name.startswith((BENCH, PROGRAM)):
                host.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return None
    w0, w1 = window
    instrument = tracing._Spans(
        [(s, e) for s, e, n in host if n == tracing.INSTRUMENT])
    busy = [(s, e) for s, e, corr, linked in device
            if runtime_at.get(corr, launched_at.get(linked)) not in
            instrument]
    gaps, cursor = [], w0
    for s, e in tracing._merged(busy) + [[w1, w1]]:
        if s > cursor:
            gaps.append((cursor, min(s, w1)))
        cursor = max(cursor, e)
    gaps = [(s, e) for s, e in gaps if e > s]

    host.sort(key=lambda x: (x[0], -x[1]))
    idle: Dict[str, float] = defaultdict(float)
    for (s, e), i in zip(gaps, _sweep_innermost(host, [s for s, _ in gaps])):
        idle[NO_SPAN if i is None else host[i][2]] += (e - s) / 1e9

    program = [x for x in host if x[2].startswith(PROGRAM)]
    spans: Dict[str, dict] = {}
    for (s, e, name), own in zip(program, _self_seconds(program)):
        row = spans.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += (e - s) / 1e9
        row["self_s"] += own
    return {
        "spans": spans,
        "idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1]),
        "idle_s": sum(idle.values()),
        "idle_in_program_s": sum(v for k, v in idle.items()
                                 if k.startswith(PROGRAM)),
    }


def without_program_copies(events, device_type) -> list:
    """``events`` less the device's copies of the program's spans, which
    ``reduce_trace`` would take for device operations."""
    return [e for e in events if not (e.device_type() == device_type
                                      and e.name().startswith(PROGRAM))]


def _mean_ms(spans: dict, name: str) -> Optional[float]:
    row = spans.get(PROGRAM + name)
    if not row or not row["count"]:
        return None
    return row["total_s"] * 1e3 / row["count"]


def span_metrics(reduced: Optional[dict], solves: list,
                 ring_peaks: list) -> dict:
    """The per-layer numbers the program's spans and counters give a
    window: the mean host milliseconds of a ``repro.round``, of a
    ``repro.superstep`` and of a ``repro.launch_runtime``; the
    ``repro.bookkeeping`` milliseconds over the window's supersteps; the
    largest ``stats["ring_peak_rows"]`` of the window's solves.  A number
    with nothing to read from is left out."""
    spans = (reduced or {}).get("spans") or {}
    steps = sum(s["supersteps"] or 0 for s in solves)
    book = spans.get(PROGRAM + "bookkeeping")
    out = {"round_issue_ms": _mean_ms(spans, "round"),
           "master_issue_ms": _mean_ms(spans, "superstep"),
           "bookkeeping_ms": (book["total_s"] * 1e3 / steps
                              if book and steps else None),
           "runtime_build_ms": _mean_ms(spans, "launch_runtime"),
           "ring_peak_rows": max(ring_peaks) if ring_peaks else None}
    return {k: v for k, v in out.items() if v is not None}


def run(cell, seed: int, seconds: float, *, spans: bool, device="cuda",
        max_solves=None) -> dict:
    """``run_cell``'s traced run of ``cell`` with the program's spans
    ``spans`` (on for the warm solve and the window); its line with
    ``spans``, ``span_metrics`` and ``ring`` added."""
    import torch

    from bench import tracing
    from bench.run import run_cell
    from repro_torch.obs import phase

    from torch.autograd import DeviceType

    device = torch.device(device)
    base = cell.kind.program(cell.config, device)
    rings: list = []

    def solve(inst):
        stats: dict = {}
        try:
            opt, stats = base(inst)
        finally:
            rings.append((stats.get("ring_refused_rows"),
                          stats.get("ring_peak_rows")))
        return opt, stats

    reduce_trace, reduced = tracing.reduce_trace, {}

    def reduce_both(events, *, device_type=DeviceType.CUDA, **kw):
        reduced.update(reduce_spans(events, device_type=device_type) or {})
        return reduce_trace(without_program_copies(events, device_type),
                            device_type=device_type, **kw)

    record: dict = {}
    prev = phase.enable_spans(spans)
    tracing.reduce_trace = reduce_both
    try:
        line = run_cell(cell, seed, seconds, 1, device=device,
                        program=solve, max_solves=max_solves,
                        record_out=record)
    finally:
        tracing.reduce_trace = reduce_trace
        phase.enable_spans(prev)
    window = rings[1:]  # after the warm solve
    line["spans"] = reduced or None
    line["span_metrics"] = span_metrics(
        reduced, record["solves"], [p for _, p in window if p is not None])
    line["ring"] = {"refused": [r for r, _ in window],
                    "peak": [p for _, p in window]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    use_checkout()
    import torch

    from bench.cell import load_cell

    if not torch.cuda.is_available():
        print("bench/spans.py: no CUDA device", file=sys.stderr)
        return 2
    line = run(load_cell(args.workload), args.seed, args.seconds,
               spans=bool(args.spans))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
