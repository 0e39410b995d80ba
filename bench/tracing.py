"""The traced run: the benchmark's spans, and the reduction of a
``torch.profiler`` trace to what the per-layer metrics read.

``bench.window`` spans the traced window and ``bench.solve`` each call of
the program in it; a kind's hooks (``bench/kinds/<kind>.py``, ``Hooks``)
add spans of their own around the program's layers, and count inside
``bench.instrument`` spans: the reduction leaves the device work launched
there out and reports the host seconds the spans took
(``instrument_host_s``).

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
from typing import Dict, Optional

__all__ = ["SOLVE", "INSTRUMENT", "WINDOW", "profiled", "reduce_trace",
           "union_s"]

WINDOW = "bench.window"
SOLVE = "bench.solve"
INSTRUMENT = "bench.instrument"
# a device operation's name as the breakdown gives it: C++ template
# names of PyTorch's kernels run to thousands of characters
NAME_CHARS = 120


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


def reduce_trace(events, *, spans=(), kernels=None, device_type=None,
                 top: int = 10) -> Optional[dict]:
    """What the per-layer metrics read from the raw profiler events of
    the traced window (``prof.profiler.kineto_results.events()``):
    device busy seconds, operations, the device seconds of the
    operations launched inside each of ``kernels``' spans (``{key:
    span}``: ``<key>_device_s`` and the three longest operations by name,
    ``<key>_ops_by_name``), the operations that took the most time, and
    idle time by what the host was doing: the innermost of
    ``bench.instrument``, ``spans`` (a kind's own, innermost first) and
    ``bench.solve`` open where a gap starts.  ``device_type``: the
    events' type of a device operation (by default
    ``torch.autograd.DeviceType.CUDA``); the device's copies of the
    benchmark's spans (named ``bench.*``) are not operations.  None where
    the trace holds no window span."""
    if device_type is None:
        from torch.autograd import DeviceType

        device_type = DeviceType.CUDA
    kernels = kernels or {}
    activity = (INSTRUMENT, *spans, SOLVE)
    # a device operation's launch: the runtime call with its correlation
    # id (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaMemcpyAsync``),
    # else the host operation its linked id names
    runtime_at: Dict[int, int] = {}
    launched_at: Dict[int, int] = {}
    host: Dict[str, list] = defaultdict(list)
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
                host[name].append((e.start_ns(), e.end_ns()))
    if not host.get(WINDOW):
        return None
    w0, w1 = host[WINDOW][0]
    found = {name: _Spans(host.get(name, ()))
             for name in (*activity, *kernels.values())}
    busy, by_name = [], defaultdict(float)
    kernel_ns = dict.fromkeys(kernels, 0)
    in_kernel = {k: defaultdict(float) for k in kernels}
    n_ops, unattributed = 0, 0
    for start, end, name, corr, linked in device:
        t = runtime_at.get(corr, launched_at.get(linked))
        if t is None:
            unattributed += 1
        elif t in found[INSTRUMENT]:
            continue
        else:
            for k, span in kernels.items():
                if t in found[span]:
                    kernel_ns[k] += end - start
                    in_kernel[k][name[:NAME_CHARS]] += (end - start) / 1e9
        busy.append((start, end))
        by_name[name[:NAME_CHARS]] += (end - start) / 1e9
        n_ops += 1
    merged = _merged(busy)
    idle = defaultdict(float)
    cursor = w0
    for s, e in merged + [[w1, w1]]:
        if s > cursor:
            idle[_activity(found, activity, cursor)] += (s - cursor) / 1e9
        cursor = max(cursor, e)
    out = {
        "window_trace_s": (w1 - w0) / 1e9,
        "instrument_host_s": union_s(host.get(INSTRUMENT, ())),
        "busy_s": sum(e - s for s, e in merged) / 1e9,
        "device_ops": n_ops,
        "unattributed_ops": unattributed,
    }
    for k in kernels:
        out[f"{k}_device_s"] = kernel_ns[k] / 1e9 if kernel_ns[k] else None
        out[f"{k}_ops_by_name"] = sorted(in_kernel[k].items(),
                                         key=lambda kv: -kv[1])[:3]
    out["top_device_ops"] = sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:top]
    out["idle_by_host"] = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return out


def _activity(found, activity, t) -> str:
    for name in activity:
        if t in found[name]:
            return name
    return "bench.between_solves"
