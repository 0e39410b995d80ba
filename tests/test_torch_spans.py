"""The program's host spans (``repro_torch.obs.phase.span``) on the CPU:
off, a span is one shared null context and a profile of a solve holds no
``repro.*`` event; on, a profiled ``parallel_solve`` shows the layers of
a round nested as the code nests them; the solver's results are the same
either way; a ``REPRO_TRACE`` block's Chrome trace shows them."""

import json

import pytest
import torch

from repro_torch.core.dd.knapsack import random_instance
from repro_torch.core.dd.parallel import parallel_solve
from repro_torch.obs import phase

from _torch_parity import one_torch_thread  # noqa: F401

KW = dict(n_workers=4, explore_width=8, batch=4, fused_rounds=4,
          device="cpu")


@pytest.fixture
def spans_on():
    prev = phase.enable_spans(True)
    yield
    phase.enable_spans(prev)


def _profiled_solve(n=12, seed=0, **kw):
    """``parallel_solve`` under a CPU profile: its result and every
    ``repro.*`` host event as ``(name, start_ns, end_ns)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        opt, stats = parallel_solve(random_instance(n, seed=seed),
                                    **{**KW, **kw})
    spans = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(phase.SPAN_PREFIX)]
    return opt, stats, spans


def _inside(spans, child, parent) -> bool:
    """Every ``repro.<child>`` span lies inside some ``repro.<parent>``
    span, and there is at least one."""
    kids = [(s, e) for n, s, e in spans if n == "repro." + child]
    outer = [(s, e) for n, s, e in spans if n == "repro." + parent]
    return bool(kids) and all(any(ps <= s and e <= pe for ps, pe in outer)
                              for s, e in kids)


def test_a_span_off_is_one_shared_null_context():
    assert phase.enable_spans(False) is False
    a, b = phase.span("solve"), phase.span("round")
    assert a is b
    with a:
        with b:  # nested use of the same object
            pass


def test_enable_spans_returns_the_previous_setting():
    assert phase.enable_spans(True) is False
    try:
        assert phase.enable_spans(True) is True
        assert phase.span("x") is not phase.span("x")
    finally:
        assert phase.enable_spans(False) is True


def test_spans_off_leave_no_event_in_a_profile():
    _, _, spans = _profiled_solve()
    assert spans == []


def test_spans_on_nest_as_the_layers_of_a_round(spans_on):
    _, stats, spans = _profiled_solve()
    names = {n for n, _, _ in spans}
    assert names == {"repro." + n for n in (
        "solve", "launch_runtime", "block", "round", "worker_body", "pop",
        "explore", "prune", "push", "superstep", "plan", "exchange",
        "adaptive_update", "read_back", "bookkeeping", "solve_end")}
    chain = ("solve", "block", "round", "worker_body", "explore")
    for parent, child in zip(chain, chain[1:]):
        assert _inside(spans, child, parent), (child, parent)
    for parent, child in (("round", "superstep"), ("superstep", "exchange"),
                          ("superstep", "plan"), ("worker_body", "pop"),
                          ("worker_body", "prune"), ("worker_body", "push"),
                          ("round", "adaptive_update"),
                          ("block", "read_back"), ("block", "bookkeeping"),
                          ("solve", "launch_runtime"),
                          ("solve", "solve_end")):
        assert _inside(spans, child, parent), (child, parent)
    count = {n: sum(1 for m, _, _ in spans if m == "repro." + n)
             for n in ("solve", "round", "superstep", "block")}
    # every block runs fused_rounds rounds, gated past the drain
    assert count["solve"] == 1
    assert count["round"] == count["superstep"] == 4 * count["block"]
    assert stats["supersteps"] <= count["round"]


def test_the_step_round_is_a_span(spans_on):
    """``StealRuntime.round`` (``fused_rounds=1``) opens ``repro.round``
    itself, with the worker body and the superstep inside."""
    _, stats, spans = _profiled_solve(fused_rounds=1)
    rounds = [x for x in spans if x[0] == "repro.round"]
    assert len(rounds) == stats["supersteps"]
    assert not any(n == "repro.block" for n, _, _ in spans)
    assert _inside(spans, "worker_body", "round")
    assert _inside(spans, "superstep", "round")


@pytest.mark.parametrize("fused", [4, 1])
def test_solver_results_equal_with_spans_on_and_off(fused):
    off = parallel_solve(random_instance(16, seed=1),
                         **{**KW, "fused_rounds": fused})
    prev = phase.enable_spans(True)
    try:
        on = parallel_solve(random_instance(16, seed=1),
                            **{**KW, "fused_rounds": fused})
    finally:
        phase.enable_spans(prev)
    assert on[0] == off[0]
    for key in ("supersteps", "explored", "transferred", "telemetry",
                "per_worker_explored", "ring_refused_rows",
                "ring_peak_rows", "per_worker_ring_peak"):
        assert on[1][key] == off[1][key], key


def test_a_traced_block_shows_the_spans(tmp_path, monkeypatch):
    """Under ``REPRO_TRACE`` the block's Chrome trace holds the program's
    spans, and they are off again after it."""
    monkeypatch.setenv("REPRO_TRACE", str(tmp_path))
    parallel_solve(random_instance(10, seed=2), **KW)
    assert phase.enable_spans(False) is False
    names = {e.get("name") for e in json.loads(
        (tmp_path / "run_fused_k4.json").read_text())["traceEvents"]}
    assert {"repro.round", "repro.worker_body", "repro.superstep",
            "repro.explore"} <= names
    assert "repro.block" not in names  # opened before the profile
