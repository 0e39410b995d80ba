"""Chrome-trace / Perfetto export of one :class:`Telemetry` stream
(PyTorch port of ``repro.obs.trace``).

One telemetry object already carries the whole story of a run on a
single logical-round timeline: the master's rounds (with per-phase time
splits when the probe was armed), the workload's waves, every served
request's admit -> first-token -> finish stamps, and the round-stamped
fault/detector event log.  This module renders that stream as standard
Trace Event Format JSON — load the file in ``chrome://tracing`` or
https://ui.perfetto.dev and the rounds, phases, waves, requests and
failures line up on one zoomable timeline.  The events are the JAX
module's, so the two packages' traces of the same records are equal.

The clock is LOGICAL: one round occupies ``round_us`` microseconds of
trace time (default 1000 us = 1 ms per round), so traces from host,
stacked and mesh runs of the same schedule align event-for-event and are
directly diffable.  Within a probed round the phase children scale the
round span by their MEASURED fractions — so the picture shows real
relative cost on the deterministic round grid.  Unprobed rounds render as
bare round spans.

Emitted events (all standard phases, no extensions):

* ``X`` complete spans, pid 0 / tid 0: one ``round N`` per
  :class:`RoundRecord`, with nested ``worker_body`` / ``exchange`` /
  ``splice`` / ``adaptive_update`` children when the record is
  phase-timed (args carry steals, items moved, proportion, imbalance,
  and whether the split was estimated).
* ``X`` spans, pid 0 / tid 1: one ``wave N`` per :class:`WaveRecord`,
  spanning from the previous wave's closing round to its own (args:
  served, tokens, loads, SLO percentiles).
* ``b``/``n``/``e`` async events, pid 0 / tid 2, one series per
  request id: ``admit -> first_token -> finish`` (args: tokens, ttft
  and latency in rounds).
* ``i`` instant events, pid 0 / tid 0, one per :attr:`Telemetry.
  fault_log` entry at the round the event was recorded, lane-attributed
  in ``args``.

``python -m repro_torch.obs.trace --smoke [--device cpu]`` drains a
small seeded chaos run with a probe and serve-style records and writes
its trace (without ``--device`` it runs on the GPU).
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from repro_torch.runtime.telemetry import Telemetry

__all__ = ["export_trace", "validate_trace"]

_PID = 0
_TID_ROUNDS = 0
_TID_WAVES = 1
_TID_REQUESTS = 2

# Phase child order must match repro_torch.obs.phase.PHASES.
_PHASE_FIELDS = (("worker_body", "t_worker"), ("exchange", "t_exchange"),
                 ("splice", "t_splice"), ("adaptive_update", "t_adaptive"))


def _meta(name: str, tid: int, label: str) -> Dict[str, Any]:
    return {"ph": "M", "pid": _PID, "tid": tid, "name": name,
            "args": {"name": label}}


def _round_events(rec, round_us: float) -> List[Dict[str, Any]]:
    ts = rec.round * round_us
    events: List[Dict[str, Any]] = [{
        "ph": "X", "pid": _PID, "tid": _TID_ROUNDS, "ts": ts,
        "dur": round_us, "name": f"round {rec.round}", "cat": "round",
        "args": {
            "n_steals": rec.n_steals,
            "n_transferred": rec.n_transferred,
            "bytes_moved": rec.bytes_moved,
            "proportion": rec.proportion,
            "imbalance": rec.imbalance,
            "sizes_total": rec.sizes_total,
        },
    }]
    if not rec.phase_timed:
        return events
    events[0]["args"]["t_round_s"] = rec.t_round
    events[0]["args"]["phase_estimated"] = rec.phase_estimated
    total = rec.t_round or 1.0
    cursor = ts
    for name, field in _PHASE_FIELDS:
        dur = round_us * (getattr(rec, field) / total)
        events.append({
            "ph": "X", "pid": _PID, "tid": _TID_ROUNDS, "ts": cursor,
            "dur": dur, "name": name, "cat": "phase",
            "args": {"seconds": getattr(rec, field),
                     "estimated": rec.phase_estimated},
        })
        cursor += dur
    return events


def _wave_events(telemetry: Telemetry, round_us: float
                 ) -> List[Dict[str, Any]]:
    events = []
    prev_round = 0
    for w in telemetry.waves:
        # A wave recorded before round alignment existed (round == -1)
        # still renders: pin it one round wide at its index.
        end = w.round if w.round >= 0 else prev_round + 1
        start = min(prev_round, end)
        dur = max(end - start, 1) * round_us
        args = {"served": w.served, "tokens": w.tokens,
                "loads": list(w.loads), "evicted": w.evicted,
                "stragglers": w.stragglers, "migrated": w.migrated}
        if w.latency_p50 or w.ttft_p50:
            args.update(ttft_p50=w.ttft_p50, ttft_p95=w.ttft_p95,
                        latency_p50=w.latency_p50, latency_p95=w.latency_p95)
        events.append({
            "ph": "X", "pid": _PID, "tid": _TID_WAVES, "ts": start * round_us,
            "dur": dur, "name": f"wave {w.wave}", "cat": "wave",
            "args": args,
        })
        prev_round = end
    return events


def _request_events(telemetry: Telemetry, round_us: float
                    ) -> List[Dict[str, Any]]:
    events = []
    for r in telemetry.requests:
        name = f"request {r.rid}"
        common = {"pid": _PID, "tid": _TID_REQUESTS, "cat": "request",
                  "id": r.rid, "name": name}
        events.append({**common, "ph": "b", "ts": r.admit * round_us,
                       "args": {"tokens": r.tokens}})
        events.append({**common, "ph": "n", "ts": r.first * round_us,
                       "name": "first_token",
                       "args": {"ttft_rounds": r.ttft}})
        events.append({**common, "ph": "e", "ts": r.finish * round_us,
                       "args": {"latency_rounds": r.latency,
                                "tokens": r.tokens}})
    return events


def _fault_events(telemetry: Telemetry, round_us: float
                  ) -> List[Dict[str, Any]]:
    events = []
    for kind, lane, rnd in telemetry.fault_log:
        args: Dict[str, Any] = {"round": rnd}
        if lane >= 0:
            args["lane"] = lane
        events.append({
            "ph": "i", "pid": _PID, "tid": _TID_ROUNDS, "ts": rnd * round_us,
            "s": "p", "name": kind, "cat": "fault", "args": args,
        })
    return events


def export_trace(telemetry: Telemetry, path: Optional[str] = None, *,
                 round_us: float = 1000.0) -> Dict[str, Any]:
    """Render ``telemetry`` as a Chrome-trace dict (and write it as JSON
    when ``path`` is given).  ``round_us`` sets the logical clock: trace
    microseconds per round."""
    events: List[Dict[str, Any]] = [
        _meta("process_name", _TID_ROUNDS, "steal-runtime"),
        _meta("thread_name", _TID_ROUNDS, "rounds"),
        _meta("thread_name", _TID_WAVES, "waves"),
        _meta("thread_name", _TID_REQUESTS, "requests"),
    ]
    for rec in telemetry.rounds:
        events.extend(_round_events(rec, round_us))
    events.extend(_wave_events(telemetry, round_us))
    events.extend(_request_events(telemetry, round_us))
    events.extend(_fault_events(telemetry, round_us))
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": {"clock": f"logical ({round_us} us per round)",
                           "summary": telemetry.summary(),
                           "phase_summary": telemetry.phase_summary()}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def validate_trace(trace: Dict[str, Any]) -> Dict[str, int]:
    """Structural check that ``trace`` is loadable Chrome-trace JSON:
    a ``traceEvents`` list whose entries all carry the mandatory
    ``ph``/``pid``/``ts`` fields (metadata events excepted for ``ts``),
    with matched async begin/end per request id.  Returns per-category
    event counts; raises ``ValueError`` on any violation — this is what
    the CI obs lane runs against the smoke trace."""
    if not isinstance(trace.get("traceEvents"), list):
        raise ValueError("trace has no traceEvents list")
    counts: Dict[str, int] = {}
    async_open: Dict[int, int] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        for field in ("ph", "pid", "name"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        if ph not in ("M", "X", "b", "n", "e", "i"):
            raise ValueError(f"event {i} has unexpected phase {ph!r}")
        if ph != "M" and "ts" not in ev:
            raise ValueError(f"event {i} ({ph!r}) missing ts")
        if ph == "X" and ev.get("dur", -1.0) < 0:
            raise ValueError(f"event {i} X span missing/negative dur")
        if ph in ("b", "n", "e") and "id" not in ev:
            raise ValueError(f"event {i} async event missing id")
        if ph == "b":
            async_open[ev["id"]] = async_open.get(ev["id"], 0) + 1
        elif ph == "e":
            open_n = async_open.get(ev["id"], 0)
            if open_n <= 0:
                raise ValueError(f"event {i} ends async id {ev['id']} "
                                 f"with no open begin")
            async_open[ev["id"]] = open_n - 1
        counts[ev.get("cat", ph)] = counts.get(ev.get("cat", ph), 0) + 1
    dangling = {k: v for k, v in async_open.items() if v}
    if dangling:
        raise ValueError(f"unclosed async request events: {dangling}")
    return counts


# ---------------------------------------------------------------------------
# Smoke driver: a tiny seeded chaos drain + serve waves, one stream
# ---------------------------------------------------------------------------


def _smoke_telemetry(device=None) -> Telemetry:
    """A deterministic miniature of the full story in one telemetry
    stream (the JAX module's, on the port's runtime): a 4-lane probed
    chaos drain (a scheduled straggler window the detector converts into
    suspects, a scheduled kill, a live revive) with serve-style wave +
    request records layered on the same round clock."""
    import torch

    from repro_torch.core.policy import StealPolicy
    from repro_torch.runtime.detector import DetectorPolicy
    from repro_torch.runtime.executor import StealRuntime
    from repro_torch.runtime.resilience import FaultPlan

    W, cap, items = 4, 64, 48
    rt = StealRuntime(
        W, cap, {"x": torch.zeros((), dtype=torch.int32)},
        policy=StealPolicy(low_watermark=1, high_watermark=4),
        device=device,
        # Lane 1 straggles rounds 2..4 (-> detector suspects), lane 3
        # dies at round 6 (-> recovery superstep drains its ring).
        fault_plan=FaultPlan(kills=((3, 6),), delays=((1, 2, 3),)))
    rt.attach_detector(DetectorPolicy(suspect_after=2, dead_after=None))
    rt.attach_phase_probe(calibrate_every=4)
    # All work starts on lane 0: the drain IS the rebalance.
    rt.push(0, {"x": torch.arange(items, dtype=torch.int32)}, items)
    ops = rt.ops

    def body(q, carry):
        q, _, n = ops.pop_bulk(q, 4, 2)
        return q, carry + n.to(torch.int32)

    admitted: List[int] = []
    for tick in range(6):
        rt.round(body)               # one round, one read-back
        rt.run_fused(2, body)        # a block of two
        if tick == 2:
            rt.revive_lane(3)
        # Serve layer on the same stream: admit one request per tick,
        # finish it two ticks later (stamps in logical rounds).
        admitted.append(rt.rounds_run)
        if tick >= 2:
            admit = admitted[tick - 2]
            rt.telemetry.record_request(rid=tick - 2, admit=admit,
                                        first=admit + 1,
                                        finish=rt.rounds_run, tokens=8)
        rt.telemetry.record_wave(loads=rt.sizes(), served=1 if tick >= 2
                                 else 0, tokens=8 if tick >= 2 else 0)
    return rt.telemetry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export a Chrome trace from the port's steal runtime")
    ap.add_argument("--smoke", action="store_true",
                    help="run the built-in seeded chaos+serve drain and "
                         "export its trace")
    ap.add_argument("--out", default="trace.json",
                    help="output path (default trace.json)")
    ap.add_argument("--round-us", type=float, default=1000.0,
                    help="trace microseconds per logical round")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("only --smoke mode is runnable from the CLI; library "
                 "users call export_trace(telemetry, path)")
    tele = _smoke_telemetry(args.device)
    trace = export_trace(tele, args.out, round_us=args.round_us)
    counts = validate_trace(trace)
    print(f"wrote {args.out}: " + ", ".join(
        f"{v} {k}" for k, v in sorted(counts.items())))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
