"""The program's spans in a traced run (``bench/spans.py``), on made-up
events and on a tiny cell on the CPU: idle time goes to the innermost
span open where a gap starts, of either family; a span's self time
leaves out the program's spans inside it; ``reduce_trace`` reads the same
with the program's spans in the trace as without them; the program's
ring counters read what ``bench/rings.py`` counts from outside."""

from __future__ import annotations

import pytest

from _bench_tiny import (BIG_SEED, KNAPSACK, tiny_cell,  # noqa: F401
                         torch_threads)
from bench import spans, tracing
from test_bench_tracing import CUDA, Ev, events, knapsack_trace

MS = 1_000_000


def nested_events():
    """A solve whose program spans sit inside and around the benchmark's:
    bench.solve > repro.solve > bench.run_fused > repro.block >
    repro.round > {repro.worker_body > bench.worker_body > repro.explore,
    repro.superstep}, then repro.bookkeeping in the block."""
    return [
        Ev(tracing.WINDOW, 0, 100 * MS, corr=1),
        Ev(tracing.SOLVE, 5 * MS, 95 * MS, corr=2),
        Ev("repro.solve", 6 * MS, 94 * MS, corr=3),
        Ev(KNAPSACK.ROUNDS, 10 * MS, 90 * MS, corr=4),
        Ev("repro.block", 10 * MS, 90 * MS, corr=5),
        Ev("repro.round", 12 * MS, 60 * MS, corr=6),
        Ev("repro.worker_body", 12 * MS, 30 * MS, corr=7),
        Ev(KNAPSACK.WORKER_BODY, 13 * MS, 29 * MS, corr=8),
        Ev("repro.explore", 15 * MS, 20 * MS, corr=9),
        Ev("aten::add", 16 * MS, 17 * MS, corr=10),
        Ev("repro.superstep", 32 * MS, 58 * MS, corr=11),
        Ev("aten::mul", 33 * MS, 34 * MS, corr=12),
        Ev("repro.bookkeeping", 70 * MS, 88 * MS, corr=13),
        # kernels: one launched in the explore, one by the superstep
        Ev("add_kernel", 18 * MS, 21 * MS, CUDA, corr=90, linked=10),
        Ev("mul_kernel", 40 * MS, 50 * MS, CUDA, corr=91, linked=12),
        # the device's copies of spans are no operations
        Ev("repro.round", 18 * MS, 50 * MS, CUDA, corr=92, linked=6),
        Ev(KNAPSACK.ROUNDS, 18 * MS, 50 * MS, CUDA, corr=93, linked=4),
    ]


def test_idle_goes_to_the_innermost_span():
    out = spans.reduce_spans(nested_events(), device_type=CUDA)
    idle = dict(out["idle_by_span"])
    # gaps start at 0 (no span), 21 (the explore's end: bench.worker_body
    # is innermost), 50 (repro.superstep)
    assert idle == pytest.approx({spans.NO_SPAN: 0.018,
                                  KNAPSACK.WORKER_BODY: 0.019,
                                  "repro.superstep": 0.050})
    assert out["idle_s"] == pytest.approx(0.087)
    assert out["idle_in_program_s"] == pytest.approx(0.050)


def test_self_time_leaves_out_the_program_spans_inside():
    rows = spans.reduce_spans(nested_events(), device_type=CUDA)["spans"]
    assert set(rows) == {"repro.solve", "repro.block", "repro.round",
                         "repro.worker_body", "repro.explore",
                         "repro.superstep", "repro.bookkeeping"}
    want = {"repro.solve": (0.088, 0.008), "repro.block": (0.080, 0.014),
            "repro.round": (0.048, 0.004),
            "repro.worker_body": (0.018, 0.013),
            "repro.explore": (0.005, 0.005),
            "repro.superstep": (0.026, 0.026),
            "repro.bookkeeping": (0.018, 0.018)}
    for name, (total, own) in want.items():
        assert rows[name]["count"] == 1
        assert rows[name]["total_s"] == pytest.approx(total), name
        assert rows[name]["self_s"] == pytest.approx(own), name


def test_siblings_sharing_a_boundary_are_not_nested():
    host = [(0, 10, "repro.a"), (10, 20, "repro.b"), (10, 15, "repro.c")]
    assert spans._self_seconds(host) == pytest.approx([10e-9, 5e-9, 5e-9])
    # at 10 all three are open: the latest and shortest is innermost
    assert spans._sweep_innermost(host, [5, 10, 12, 17, 25]) == [
        0, 2, 2, 1, None]


def test_no_window_no_spans():
    assert spans.reduce_spans(nested_events()[1:], device_type=CUDA) is None


def test_reduce_trace_reads_the_same_with_program_spans():
    """The program's host spans, and their device copies once left out,
    change nothing ``reduce_trace`` reports."""
    extra = [Ev("repro.solve", 10 * MS, 60 * MS, corr=200),
             Ev("repro.explore", 20 * MS, 30 * MS, corr=201),
             Ev("repro.explore", 24 * MS, 29 * MS, CUDA, corr=202,
                linked=201)]
    want = knapsack_trace(events())
    got = knapsack_trace(spans.without_program_copies(events() + extra,
                                                      CUDA))
    assert got == want


def test_span_metrics_of_a_fixed_record():
    reduced = {"spans": {
        "repro.round": {"count": 8, "total_s": 0.040, "self_s": 0.001},
        "repro.superstep": {"count": 8, "total_s": 0.016, "self_s": 0.0},
        "repro.bookkeeping": {"count": 1, "total_s": 0.006, "self_s": 0.0},
        "repro.launch_runtime": {"count": 2, "total_s": 0.030,
                                 "self_s": 0.0}}}
    solves = [{"supersteps": 5}, {"supersteps": 1}, {"supersteps": None}]
    got = spans.span_metrics(reduced, solves, [120, 340])
    assert got == pytest.approx({"round_issue_ms": 5.0,
                                 "master_issue_ms": 2.0,
                                 "bookkeeping_ms": 1.0,
                                 "runtime_build_ms": 15.0,
                                 "ring_peak_rows": 340})
    # nothing to read: every number left out
    assert spans.span_metrics(None, solves, []) == {}


def test_a_tiny_cell_with_the_program_spans(torch_threads):  # noqa: F811
    # the window closes after 3 solves, however slow the host
    line = spans.run(tiny_cell("ks-uncorr-series"), BIG_SEED, 600.0,
                     spans=True, device="cpu", max_solves=3)
    assert line["correct"] is True and line["attempted"] == 3
    assert set(line["span_metrics"]) == {
        "round_issue_ms", "master_issue_ms", "bookkeeping_ms",
        "runtime_build_ms", "ring_peak_rows"}
    assert all(v > 0 for v in line["span_metrics"].values())
    assert line["ring"]["refused"] == [0, 0, 0]
    assert max(line["ring"]["peak"]) == line["span_metrics"][
        "ring_peak_rows"] <= 512
    rows = line["spans"]["spans"]
    assert rows["repro.solve"]["count"] == 3
    assert rows["repro.round"]["count"] >= 3
    # spans off: the same traced run, with no program span in it
    off = spans.run(tiny_cell("ks-uncorr-series"), BIG_SEED, 600.0,
                    spans=False, device="cpu", max_solves=3)
    assert off["spans"]["spans"] == {}
    assert set(off["span_metrics"]) == {"ring_peak_rows"}


def test_program_peak_equals_the_counted_peak(torch_threads):  # noqa: F811
    """A solve's post-push peak, kept by the program, equals what
    ``bench/rings.py`` counts on the same solve from outside."""
    import torch

    from bench import rings
    from repro_torch.core.dd import parallel
    from repro_torch.core.dd.knapsack import random_instance

    with rings.counted(parallel, torch) as counter:
        _, stats = parallel.parallel_solve(
            random_instance(24, seed=2), device="cpu", n_workers=8,
            explore_width=8, batch=4, fused_rounds=8)
    counts = counter.counts()
    assert max(stats["per_worker_ring_peak"]) == counts["ring_peak_rows"]
    assert stats["ring_refused_rows"] == counts["ring_clamped_rows"] == 0
