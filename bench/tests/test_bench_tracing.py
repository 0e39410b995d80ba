"""The reduction of a profiler trace, on made-up events: each device
operation is charged to the benchmark's spans around the host operation
that launched it, the instrumentation's own work is left out, and idle
time goes to what the host was doing."""

from __future__ import annotations

import pytest

from _bench_tiny import KNAPSACK, ROOT, torch_threads  # noqa: F401
from bench import tracing

CPU, CUDA = "cpu", "cuda"


class Ev:
    def __init__(self, name, start, end, dev=CPU, corr=0, linked=0):
        self._v = (name, start, end, dev, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def events():
    ms = 1_000_000
    return [
        Ev(tracing.WINDOW, 0, 100 * ms, corr=1),
        Ev(tracing.SOLVE, 10 * ms, 60 * ms, corr=2),
        Ev(KNAPSACK.EXPLORE, 20 * ms, 30 * ms, corr=3),
        Ev("aten::empty", 21 * ms, 22 * ms, corr=4),
        Ev(tracing.INSTRUMENT, 31 * ms, 32 * ms, corr=5),
        Ev("aten::sum", 31 * ms, 32 * ms, corr=6),
        Ev("aten::add", 40 * ms, 41 * ms, corr=7),
        # the explore kernel, launched through ctypes inside the span: no
        # host operation links it, its runtime call does
        Ev("cuLaunchKernel", 22 * ms, 23 * ms, corr=90, linked=0),
        Ev("explore_kernel", 24 * ms, 28 * ms, CUDA, corr=90, linked=0),
        # a kernel of an aten op inside the explore span
        Ev("fill_kernel", 28 * ms, 29 * ms, CUDA, corr=91, linked=4),
        # the instrumentation's reduction: left out
        Ev("reduce_kernel", 33 * ms, 35 * ms, CUDA, corr=92, linked=6),
        # an op of the solve outside the explore
        Ev("add_kernel", 42 * ms, 44 * ms, CUDA, corr=93, linked=7),
        # its launch is not in the trace
        Ev("orphan_kernel", 70 * ms, 71 * ms, CUDA, corr=94, linked=999),
        # the device's copy of a span is no operation
        Ev(KNAPSACK.EXPLORE, 24 * ms, 29 * ms, CUDA, corr=95, linked=3),
    ]


def knapsack_trace(events):
    """``reduce_trace`` with the knapsack kind's spans."""
    hooks = KNAPSACK.Hooks
    return tracing.reduce_trace(events, spans=hooks.SPANS,
                                kernels=hooks.KERNELS, device_type=CUDA)


def test_reduction_of_made_up_events():
    out = knapsack_trace(events())
    assert out["device_ops"] == 4 and out["unattributed_ops"] == 1
    assert out["window_trace_s"] == pytest.approx(0.1)
    assert out["instrument_host_s"] == pytest.approx(0.001)
    assert out["explore_device_s"] == pytest.approx(0.005)
    assert out["busy_s"] == pytest.approx(0.005 + 0.002 + 0.001)
    top = dict(out["top_device_ops"])
    assert top == pytest.approx({"explore_kernel": 0.004,
                                 "add_kernel": 0.002, "fill_kernel": 0.001,
                                 "orphan_kernel": 0.001})
    idle = dict(out["idle_by_host"])
    # gaps start at 0 (no span), 29 (explore), 44 (solve), 71 (none)
    assert idle == pytest.approx({"bench.between_solves": 0.024 + 0.029,
                                  KNAPSACK.EXPLORE: 0.013,
                                  tracing.SOLVE: 0.026})
    assert sum(idle.values()) + out["busy_s"] == pytest.approx(0.1)


def test_no_window_no_reduction():
    assert knapsack_trace(events()[1:]) is None


def test_union_of_intervals():
    assert tracing.union_s([(0, 10), (5, 20), (30, 40)]) == 30e-9


def test_harvest_lets_each_runtime_go(torch_threads):  # noqa: F811
    """A traced solve's runtime is freed by reference counting once its
    phase times are taken, not left to the cyclic collector with its
    queues on the device."""
    import gc
    import weakref

    import torch

    from _bench_tiny import tiny_cell
    from repro_torch.core.dd.knapsack import Knapsack

    solve = KNAPSACK.program(tiny_cell("ks-uncorr-series").config,
                             torch.device("cpu"))
    hooks = KNAPSACK.Hooks(torch)
    hooks.install()
    gc.disable()
    try:
        solve(Knapsack((3, 2, 4, 6), (8, 5, 7, 6), 7))
        [runtime] = map(weakref.ref, hooks.runtimes)
        hooks.harvest()
        assert runtime() is None and hooks.rounds
    finally:
        gc.enable()
        hooks.remove()
