"""The port's Chrome-trace export (``repro_torch.obs.trace``) against the
JAX package's ``repro.obs.trace`` on the CPU: the same telemetry records
(phase times fixed by hand) export to the same trace, string for string;
``validate_trace`` rejects the same malformed traces; and the
``--smoke`` driver drains the JAX smoke's chaos run on the port's runtime
to the same telemetry summary and a valid trace."""

import json

import pytest

from repro.obs import trace as jtrace
from repro.runtime.telemetry import Telemetry as JaxTelemetry
from repro_torch.obs import trace as ttrace
from repro_torch.runtime.telemetry import Telemetry

from _torch_parity import one_torch_thread  # noqa: F401


def _records(cls):
    """Rounds (two of them phase-timed, one estimated), waves with and
    without SLOs, requests and lane- and cluster-level fault events."""
    tele = cls(item_bytes=4, capacity=32)
    tele.record_fault("planned_kill")
    tele.record_wave(loads=[1, 2], served=0)  # before any round
    for r in range(5):
        phases = None
        if r in (1, 3):
            phases = {"t_worker": 0.001 * r, "t_exchange": 0.0025,
                      "t_splice": 0.0005 * r, "t_adaptive": 1e-4,
                      "t_round": 0.0035 + 0.0015 * r + 1e-4,
                      "phase_estimated": r == 3}
        tele.record(sizes=[r, 2 * r, 3, 0], n_steals=r % 2,
                    n_transferred=3 * r, proportion=0.5 + 0.01 * r,
                    bytes_moved=128 * r, phases=phases)
        if r == 2:
            tele.record_fault("suspect", lane=1)
            tele.record_fault("straggler", lane=1)
        tele.record_request(rid=r, admit=r, first=r + 1, finish=r + 3,
                            tokens=4 + r)
        tele.record_wave(loads=[r, 4 - r], served=1, tokens=4 + r,
                         migrated=r % 2)
    # a phase-timed round whose split is all zero (total 0)
    tele.record(sizes=[0, 0, 0, 0], n_steals=0, n_transferred=0,
                proportion=0.5, phases={"t_round": 0.0})
    tele.record_fault("revive", lane=3)
    return tele


@pytest.mark.parametrize("round_us", [1000.0, 250.0])
def test_export_trace_matches_the_jax_package(tmp_path, round_us):
    want = jtrace.export_trace(_records(JaxTelemetry),
                               str(tmp_path / "jax.json"), round_us=round_us)
    got = ttrace.export_trace(_records(Telemetry),
                              str(tmp_path / "port.json"), round_us=round_us)
    assert json.dumps(got) == json.dumps(want)
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    counts = ttrace.validate_trace(got)
    assert counts == jtrace.validate_trace(want)
    assert counts["phase"] == 12 and counts["round"] == 6
    assert counts["request"] == 15 and counts["fault"] == 4


MALFORMED = {
    "no_events": {"traceEvents": None},
    "missing_name": {"traceEvents": [{"ph": "X", "pid": 0, "ts": 0.0,
                                      "dur": 1.0}]},
    "bad_phase": {"traceEvents": [{"ph": "Q", "pid": 0, "ts": 0.0,
                                   "name": "q"}]},
    "missing_ts": {"traceEvents": [{"ph": "i", "pid": 0, "name": "kill"}]},
    "no_dur": {"traceEvents": [{"ph": "X", "pid": 0, "ts": 0.0,
                                "name": "no-dur"}]},
    "negative_dur": {"traceEvents": [{"ph": "X", "pid": 0, "ts": 0.0,
                                      "dur": -1.0, "name": "neg"}]},
    "async_no_id": {"traceEvents": [{"ph": "b", "pid": 0, "ts": 0.0,
                                     "name": "r"}]},
    "unmatched_begin": {"traceEvents": [{"ph": "b", "pid": 0, "ts": 0.0,
                                         "name": "unmatched", "id": 7,
                                         "cat": "request"}]},
    "end_without_begin": {"traceEvents": [{"ph": "e", "pid": 0, "ts": 0.0,
                                           "name": "r", "id": 3}]},
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_validate_trace_rejects_what_the_jax_package_rejects(name):
    trace = MALFORMED[name]
    with pytest.raises(ValueError) as want:
        jtrace.validate_trace(trace)
    with pytest.raises(ValueError) as got:
        ttrace.validate_trace(trace)
    assert str(got.value) == str(want.value)


def test_smoke_driver_matches_the_jax_smoke(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert ttrace.main(["--smoke", "--device", "cpu", "--out",
                        str(out)]) == 0
    assert capsys.readouterr().out.startswith(f"wrote {out}: ")
    trace = json.loads(out.read_text())
    counts = ttrace.validate_trace(trace)
    want = jtrace._smoke_telemetry()
    assert trace["otherData"]["summary"] == want.summary()
    assert counts["round"] == want.summary()["rounds"] == 18
    # every round measured, so four phase children each; none estimated
    assert counts["phase"] == 4 * 18
    assert trace["otherData"]["phase_summary"]["estimated_rounds"] == 0
    with pytest.raises(SystemExit):
        ttrace.main([])
