"""The port's phase attribution (``repro_torch.obs.phase`` and the probed
``StealRuntime``) on the CPU: ``PhaseProbe`` and
``Telemetry.phase_summary`` equal to the JAX package's on the same
numbers; a probed runtime bit-identical to an unprobed one over
``round``, ``run_fused`` and ``until_drained`` blocks, flat, under a fault
plan and in pods, with every round measured and none estimated; a
disabled or absent probe makes no mark; ``trace_span`` writes a Chrome
trace only under ``REPRO_TRACE``."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro.obs import phase as jphase
from repro.runtime.telemetry import Telemetry as JaxTelemetry
from repro_torch.obs import phase as tphase
from repro_torch.runtime.telemetry import RoundRecord, Telemetry

from _torch_fault import (DEAD_POD_PLAN, FLAT_PLAN, POD, W, port_runtime,
                          queues_np, torch_dag_body)
from _torch_parity import one_torch_thread  # noqa: F401

RECORD_FIELDS = [f.name for f in dataclasses.fields(RoundRecord)
                 if not f.name.startswith("t_")
                 and not f.name.startswith("phase_")]


def _probe_script(mod):
    """One script of every PhaseProbe call; what it returned on the way."""
    probe = mod.PhaseProbe(calibrate_every=3)
    seen = [probe.needs_calibration("f", 0)]
    probe.store_calibration("f", (0.2, 0.3, -0.1, 0.5), rounds_run=0)
    seen += [probe.fractions("f").tolist(), probe.needs_calibration("f", 2),
             probe.needs_calibration("f", 3)]
    probe.store_calibration("zero", (0.0, -1.0, 0.0, 0.0), rounds_run=5)
    seen.append(probe.fractions("zero").tolist())  # the uniform split
    seen.append(probe.estimated_sample("f", 0.01, n=3).as_record())
    for kw in (dict(t_worker=1e-3, t_exchange=3e-3, t_full=6e-3,
                    t_adaptive=5e-4),
               dict(t_worker=-1e-6, t_exchange=2e-3, t_full=1e-3,
                    t_adaptive=-2e-6),
               dict(t_worker=2e-3, t_exchange=1e-3, t_full=4e-3,
                    t_adaptive=0.0)):
        sample = probe.direct_sample(**kw)
        seen.append((sample.as_record(), dataclasses.astuple(sample)))
    seen += [probe.rounds_attributed, probe.calibrations, probe.enabled,
             probe.calibrate_every, mod.PHASES]
    return seen


def test_phase_probe_matches_the_jax_package():
    assert _probe_script(tphase) == _probe_script(jphase)
    assert tphase.PhaseProbe(calibrate_every=0).calibrate_every == 1


def _telemetry_script(cls, phased: bool):
    tele = cls(item_bytes=4, capacity=16)
    rng = np.random.default_rng(3)
    for r in range(6):
        phases = None
        if phased and r != 2:  # one unprobed round among probed ones
            parts = rng.uniform(0.0, 1e-3, 4)
            phases = {"t_worker": parts[0], "t_exchange": parts[1],
                      "t_splice": parts[2], "t_adaptive": parts[3],
                      "t_round": float(parts.sum()),
                      "phase_estimated": r == 5}
        tele.record(sizes=rng.integers(0, 16, 4), n_steals=r % 3,
                    n_transferred=2 * r, proportion=0.5,
                    bytes_moved=64 * r, phases=phases)
    return tele


@pytest.mark.parametrize("phased", [True, False])
def test_phase_summary_matches_the_jax_package(phased):
    want = _telemetry_script(JaxTelemetry, phased)
    got = _telemetry_script(Telemetry, phased)
    assert got.phase_summary() == want.phase_summary()
    assert got.summary() == want.summary()
    assert [dataclasses.asdict(r) for r in got.rounds] == [
        dataclasses.asdict(r) for r in want.rounds]
    if not phased:
        assert got.phase_summary() == {"timed_rounds": 0}


def _drive(rt):
    """2 rounds, a fused block of 3, then until-drained blocks of 8 (the
    last one runs past the drain)."""
    body = torch_dag_body(rt.ops)
    carry = torch.zeros((W,), dtype=torch.int32)
    t0 = time.perf_counter()
    for _ in range(2):
        carry, _ = rt.round(body, carry)
    carry, _ = rt.run_fused(3, body, carry)
    while rt.total_size() > 0:
        carry, _, _ = rt.run_fused(8, body, carry, until_drained=True)
    return carry, time.perf_counter() - t0


CASES = {"flat": (None, None), "faults": (FLAT_PLAN, None),
         "pods": (DEAD_POD_PLAN, POD)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_probed_runtime_is_bit_identical(case):
    plan, pod = CASES[case]
    runs = {}
    for probed in (False, True):
        rt = port_runtime(plan, pod)
        rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
        probe = rt.attach_phase_probe() if probed else None
        runs[probed] = (rt, *_drive(rt), probe)
    (ref, ref_carry, _, _), (rt, carry, wall, probe) = runs[False], runs[True]
    assert carry.tolist() == ref_carry.tolist()
    for a, b in zip(queues_np(ref), queues_np(rt)):
        np.testing.assert_array_equal(a, b)
    assert rt.telemetry.summary() == ref.telemetry.summary()
    assert rt.controller.history == ref.controller.history
    for a, b in zip(ref.telemetry.rounds, rt.telemetry.rounds):
        assert [getattr(a, f) for f in RECORD_FIELDS] == [
            getattr(b, f) for f in RECORD_FIELDS]
    rounds = rt.rounds_run
    ps = rt.telemetry.phase_summary()
    assert ps["timed_rounds"] == rounds and ps["estimated_rounds"] == 0
    assert probe.rounds_attributed == rounds and probe.calibrations == 0
    assert all(p["total_s"] >= 0 for p in ps["phases"].values())
    assert sum(p["fraction"] for p in ps["phases"].values()) == \
        pytest.approx(1.0, abs=1e-9)
    assert 0 < ps["wall_s"] <= wall
    assert all(r.phase_timed and not r.phase_estimated
               and r.t_round == pytest.approx(
                   r.t_worker + r.t_exchange + r.t_splice + r.t_adaptive)
               for r in rt.telemetry.rounds)
    assert ref.telemetry.phase_summary() == {"timed_rounds": 0}


def test_disabled_or_absent_probe_makes_no_mark(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a mark or an event without an enabled probe")

    monkeypatch.setattr(tphase.PhaseClock, "start", refuse)
    monkeypatch.setattr(tphase.PhaseClock, "mark", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    runs = []
    for disable in (None, True):
        rt = port_runtime(FLAT_PLAN)
        rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
        if disable:
            rt.attach_phase_probe().enabled = False
        runs.append((rt, _drive(rt)[0]))
    (ref, ref_carry), (off, off_carry) = runs
    assert off.telemetry.phase_summary() == {"timed_rounds": 0}
    assert off_carry.tolist() == ref_carry.tolist()
    assert off.telemetry.summary() == ref.telemetry.summary()
    for a, b in zip(queues_np(ref), queues_np(off)):
        np.testing.assert_array_equal(a, b)


def test_every_round_is_measured_none_estimated():
    """2 rounds and a fused block of 3: 5 direct samples (the JAX package
    counts the same 5, with one calibration for its estimated block)."""
    rt = port_runtime()
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    probe = rt.attach_phase_probe(calibrate_every=1000)
    body = torch_dag_body(rt.ops)
    carry = torch.zeros((W,), dtype=torch.int32)
    for _ in range(2):
        carry, _ = rt.round(body, carry)
    rt.run_fused(3, body, carry)
    assert probe.rounds_attributed == 5 and probe.calibrations == 0
    assert rt.telemetry.phase_summary()["estimated_rounds"] == 0


def test_phase_clock_splits_rounds_at_the_adaptive_mark():
    clock = tphase.PhaseClock("cpu")
    clock.start()
    for phase in tphase.PHASES + tphase.PHASES[:3]:
        clock.mark(phase)
    rounds = clock.rounds()
    assert len(rounds) == 2 and rounds[1]["adaptive_update"] == 0.0
    assert all(v >= 0 for r in rounds for v in r.values())
    clock.start()
    assert clock.rounds() == []


def test_trace_span_writes_a_chrome_trace_only_when_asked(tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    with tphase.trace_span("off"):
        torch.ones(4).sum()
    monkeypatch.setenv("REPRO_TRACE", str(tmp_path / "traces"))
    with tphase.trace_span("outer"):
        with tphase.trace_span("inner"):  # inside a running profile
            torch.ones(4).sum()
    assert [p.name for p in (tmp_path / "traces").iterdir()] == ["outer.json"]
    events = json.loads((tmp_path / "traces" / "outer.json").read_text())
    assert events["traceEvents"]
    rt = port_runtime()
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    rt.run_fused(2, torch_dag_body(rt.ops))
    assert (tmp_path / "traces" / "run_fused_k2.json").exists()


def test_timed_call_returns_the_outputs():
    t, out = tphase.timed_call(lambda a, b: (a + b, {"x": a}),
                               (torch.ones(3), torch.ones(3)))
    assert t >= 0 and out[0].tolist() == [2.0] * 3
