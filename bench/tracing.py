"""The traced run: the benchmark's spans around the program's layers,
and the reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

:class:`Hooks` wraps, for the traced run only, the names that
``repro_torch.core.dd.parallel.parallel_solve`` calls: ``launch_runtime``
(a span, and the runtime's phase probe armed so that every round records
the device time of its worker body and its exchange), ``run_fused`` (a
span a block of rounds), ``_make_worker_body`` (a span a worker body) and
``explore_batch`` (a span an explore, and the explore's inputs counted
for its operations).  That count, the benchmark's only device work in
the window, runs inside ``bench.instrument`` spans: the reduction leaves
the device work launched there out and reports the host seconds the
spans took (``instrument_host_s``), which ``superstep_ms`` and
``worker_body_ms`` include.  Nothing is wrapped in an untraced run.

:func:`reduce_trace` reads the profiler's raw events once: each device
operation (kernel, copy, set) is tied through its linked correlation id
to the host operation that launched it, and through that operation's
start to the benchmark's spans around it: the runtime call that has the
operation's correlation id, or else the host operation its linked id
names.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional

from bench import opcount

__all__ = ["SOLVE", "LAUNCH_RUNTIME", "ROUNDS", "WORKER_BODY", "EXPLORE",
           "INSTRUMENT", "WINDOW", "Hooks", "profiled", "reduce_trace",
           "union_s"]

WINDOW = "bench.window"
SOLVE = "bench.solve"
LAUNCH_RUNTIME = "bench.launch_runtime"
ROUNDS = "bench.run_fused"
WORKER_BODY = "bench.worker_body"
EXPLORE = "bench.explore"
INSTRUMENT = "bench.instrument"
# innermost first: the host activity an idle gap is charged to
_HOST_ACTIVITY = (INSTRUMENT, EXPLORE, WORKER_BODY, ROUNDS, LAUNCH_RUNTIME,
                  SOLVE)
# a device operation's name as the breakdown gives it: C++ template
# names of PyTorch's kernels run to thousands of characters
NAME_CHARS = 120


class Hooks:
    """The traced run's wrappers on ``repro_torch.core.dd.parallel``."""

    def __init__(self, parallel, torch) -> None:
        self.parallel = parallel
        self.rf = torch.profiler.record_function
        self.saved: Dict[str, object] = {}
        self.runtimes: list = []
        self.rounds: List[Dict[str, float]] = []
        self.explore_calls = 0
        self.explore_bytes = 0
        self.width = None
        self._layers = None      # device: layers the explores walk

    # -- counting, inside bench.instrument spans ---------------------------

    def note_explore(self, layer, valid, *, width: int, n_vars: int) -> None:
        with self.rf(INSTRUMENT):
            layers = opcount.explore_layers(layer, valid, n_vars)
            self._layers = (layers if self._layers is None
                            else self._layers + layers)
        self.explore_calls += 1
        self.explore_bytes += opcount.explore_bytes(
            int(layer.shape[0]), width=width, n_vars=n_vars)
        self.width = width

    # -- the wrappers --------------------------------------------------------

    def install(self) -> None:
        par, rf, hooks = self.parallel, self.rf, self
        launch, make_body, explore = (par.launch_runtime,
                                      par._make_worker_body,
                                      par.explore_batch)
        self.saved = {"launch_runtime": launch,
                      "_make_worker_body": make_body,
                      "explore_batch": explore}

        def launch_runtime(*a, **kw):
            with rf(LAUNCH_RUNTIME):
                rt = launch(*a, **kw)
            rt.attach_phase_probe()
            run_fused = rt.run_fused

            def traced_run_fused(*a, **kw):
                with rf(ROUNDS):
                    return run_fused(*a, **kw)

            rt.run_fused = traced_run_fused
            hooks.runtimes.append(rt)
            return rt

        def _make_worker_body(*a, **kw):
            body = make_body(*a, **kw)

            def traced_body(q, carry):
                with rf(WORKER_BODY):
                    return body(q, carry)

            return traced_body

        def explore_batch(subs, valid, weights, profits, *, width, n_vars):
            with rf(EXPLORE):
                out = explore(subs, valid, weights, profits, width=width,
                              n_vars=n_vars)
            hooks.note_explore(subs.layer, valid, width=width, n_vars=n_vars)
            return out

        par.launch_runtime = launch_runtime
        par._make_worker_body = _make_worker_body
        par.explore_batch = explore_batch

    def remove(self) -> None:
        for name, fn in self.saved.items():
            setattr(self.parallel, name, fn)
        self.saved = {}

    def harvest(self) -> None:
        """Take the phase times of the rounds of the runtimes made since
        the last harvest, and let the runtimes go: the wrapped
        ``run_fused`` refers to its runtime, so it is taken off first, or
        each runtime's queues would wait for the cyclic collector."""
        for rt in self.runtimes:
            self.rounds.extend(
                {"worker_body": r.t_worker, "exchange": r.t_exchange}
                for r in rt.telemetry.rounds if r.phase_timed)
            del rt.run_fused
        self.runtimes.clear()

    def counts(self) -> dict:
        """The device counters, read once after the window."""
        def val(x):
            return None if x is None else int(x)
        layers = val(self._layers)
        ops = (None if layers is None
               else layers * opcount.ops_per_layer(self.width))
        return {"explore_calls": self.explore_calls,
                "explore_layers": layers, "explore_ops": ops,
                "explore_bytes": self.explore_bytes}


@contextlib.contextmanager
def profiled(cuda: bool):
    """``torch.profiler``'s trace of the block (host operations, the
    benchmark's spans and, with ``cuda``, the device's operations): yields
    a dict whose ``"events"``, the profiler's raw events, the block's end
    fills."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out: dict = {}
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    out["events"] = prof.profiler.kineto_results.events()


# ------------------------------------------------------------ the reduction


def union_s(intervals) -> float:
    """Seconds covered by the union of ``(start_ns, end_ns)`` intervals."""
    return sum(e - s for s, e in _merged(intervals)) / 1e9


def _merged(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Spans:
    """The benchmark's spans of one name, for containment queries."""

    def __init__(self, spans) -> None:
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends = [e for _, e in spans]

    def __contains__(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def reduce_trace(events, *, device_type=None, top: int = 10
                 ) -> Optional[dict]:
    """What the per-layer metrics read from the raw profiler events of
    the traced window (``prof.profiler.kineto_results.events()``):
    device busy seconds, operations, the explore's device seconds, the
    operations that took the most time, and idle time by what the host
    was doing.  ``device_type``: the events' type of a device operation
    (by default ``torch.autograd.DeviceType.CUDA``); the device's copies
    of the benchmark's spans (named ``bench.*``) are not operations.
    None where the trace holds no window span."""
    if device_type is None:
        from torch.autograd import DeviceType

        device_type = DeviceType.CUDA
    # a device operation's launch: the runtime call with its correlation
    # id (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``),
    # else the host operation its linked id names
    runtime_at: Dict[int, int] = {}
    launched_at: Dict[int, int] = {}
    spans: Dict[str, list] = defaultdict(list)
    device = []
    for e in events:
        name = e.name()
        if e.device_type() == device_type:
            if not name.startswith("bench."):
                device.append((e.start_ns(), e.end_ns(), name,
                               e.correlation_id(),
                               e.linked_correlation_id()))
        elif name.startswith("cu"):
            runtime_at[e.correlation_id()] = e.start_ns()
        elif e.linked_correlation_id() == 0:
            launched_at[e.correlation_id()] = e.start_ns()
            if name.startswith("bench."):
                spans[name].append((e.start_ns(), e.end_ns()))
    if not spans.get(WINDOW):
        return None
    w0, w1 = spans[WINDOW][0]
    found = {name: _Spans(spans.get(name, ())) for name in _HOST_ACTIVITY}
    busy, by_name, in_explore = [], defaultdict(float), defaultdict(float)
    explore_ns, n_ops, unattributed = 0, 0, 0
    for start, end, name, corr, linked in device:
        t = runtime_at.get(corr, launched_at.get(linked))
        if t is None:
            unattributed += 1
        elif t in found[INSTRUMENT]:
            continue
        elif t in found[EXPLORE]:
            explore_ns += end - start
            in_explore[name[:NAME_CHARS]] += (end - start) / 1e9
        busy.append((start, end))
        by_name[name[:NAME_CHARS]] += (end - start) / 1e9
        n_ops += 1
    merged = _merged(busy)
    idle = defaultdict(float)
    cursor = w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            idle[_activity(found, cursor)] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    return {
        "window_trace_s": (w1 - w0) / 1e9,
        "instrument_host_s": union_s(spans.get(INSTRUMENT, ())),
        "busy_s": sum(e - s for s, e in merged) / 1e9,
        "device_ops": n_ops,
        "unattributed_ops": unattributed,
        "explore_device_s": explore_ns / 1e9 if explore_ns else None,
        "explore_ops_by_name": sorted(in_explore.items(),
                                      key=lambda kv: -kv[1])[:3],
        "top_device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_by_host": sorted(idle.items(), key=lambda kv: -kv[1])[:top],
    }


def _activity(found, t) -> str:
    for name in _HOST_ACTIVITY:
        if t in found[name]:
            return name
    return "bench.between_solves"
