"""The port's metrics exposition (``repro_torch.obs.metrics``) against the
JAX package's ``repro.obs.metrics`` on the CPU: the same calls give the
same Prometheus text and the same snapshots, string for string, for the
registry itself, a runtime after a seeded faulted drain (the one gauge the
port has no counterpart for, ``repro_compiled_programs``, absent), both
admission masters and a serving cluster on one scripted workload, and a
``PagedQueue`` through spills and refills; ``write_textfile`` is atomic
and ``run_resilient(metrics_path=)`` keeps a throttled textfile whose
last write is the final poll."""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.policy import StealPolicy as JaxPolicy
from repro.core.queue import PagedQueue as JaxPagedQueue
from repro.distributed.serve import RuntimeAdmissionMaster as JaxDeviceMaster
from repro.obs import metrics as jm
from repro.runtime import FaultPlan as JaxFaultPlan
from repro.runtime import StealRuntime as JaxRuntime
from repro.runtime.detector import DetectorPolicy as JaxDetectorPolicy
from repro.serve.engine import ServeCluster as JaxServeCluster
from repro.serve.scheduler import AdmissionMaster as JaxMaster
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.core.policy import StealPolicy
from repro_torch.core.queue import PagedQueue
from repro_torch.distributed.serve import RuntimeAdmissionMaster
from repro_torch.launch import resilient
from repro_torch.obs import metrics as tm
from repro_torch.runtime import FaultPlan, StealRuntime
from repro_torch.runtime.detector import DetectorPolicy
from repro_torch.serve.engine import ServeCluster
from repro_torch.serve.scheduler import AdmissionMaster, Request

from _torch_parity import one_torch_thread  # noqa: F401

COMPILED = "repro_compiled_programs"
POLICY = dict(low_watermark=1, high_watermark=8)
# tests/test_obs.py's seeded drain, with a kill, a straggler window and a
# detector that suspects it
PLAN = dict(kills=((3, 4),), delays=((1, 1, 3),))


def _without_compiled(text: str) -> str:
    """The JAX text without the gauge the port does not export."""
    return "".join(line + "\n" for line in text.splitlines()
                   if COMPILED not in line)


def _registry_script(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("t_total", "a counter")
    c.inc(2, lane=0)
    c.inc(3, lane=1)
    c.inc(0.25, lane=1)
    c.set_total(7, lane=2)
    reg.counter("t_plain_total", "unlabelled").inc()
    g = reg.gauge("t_gauge", "a gauge")
    g.set(1.5)
    g.set(1e-7, kind="tiny", zone="b")
    g.set(123456789.0, kind="huge", zone="a")
    h = reg.histogram("t_hist", "a histogram", buckets=(4, 1, 2))
    for v in (0.5, 3, 100, 2):
        h.observe(v)
    h2 = reg.histogram("t_hist_lab", "labelled")
    for v, lane in ((1, 0), (9, 0), (300, 1)):
        h2.observe(v, lane=lane)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("t_total", "type clash")
    assert reg.counter("t_total") is c  # get-or-create
    return reg


def test_registry_script_matches_the_jax_package():
    want, got = _registry_script(jm), _registry_script(tm)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.snapshot() == want.snapshot()
    assert [m.name for m in got] == [m.name for m in want]
    assert 't_hist_bucket{le="+Inf"} 4' in got.to_prometheus()


def test_write_textfile_is_atomic(tmp_path):
    reg = tm.MetricsRegistry()
    reg.counter("t_total", "c").inc()
    path = tmp_path / "metrics" / "repro.prom"
    tm.write_textfile(reg, str(path))
    assert path.read_text() == reg.to_prometheus()
    assert path.read_text().rstrip().endswith("t_total 1")
    assert list(path.parent.iterdir()) == [path]  # no .tmp left behind


def _seeded_drain(runtime, push, body, make_carry):
    """tests/test_obs.py's drive: 48 items on lane 0, 5 rounds, then a
    fused block of 2."""
    push(runtime)
    carry = make_carry()
    for _ in range(5):
        carry, _ = runtime.round(body, carry)
    runtime.run_fused(2, body, carry)
    return runtime


@pytest.fixture(scope="module")
def drained_runtimes():
    jrt = JaxRuntime(4, 64, {"x": jax.ShapeDtypeStruct((), jnp.int32)},
                     policy=JaxPolicy(**POLICY), max_pop=4,
                     fault_plan=JaxFaultPlan(**PLAN))
    jrt.attach_detector(JaxDetectorPolicy(suspect_after=2))
    jops = jrt.ops

    def jbody(q, carry):
        q, _, n = jops.pop_bulk(q, 4, jnp.int32(2))
        return q, carry + n

    _seeded_drain(
        jrt, lambda rt: rt.push(0, {"x": jnp.arange(48, dtype=jnp.int32)},
                                48),
        jbody, lambda: jnp.zeros((4,), jnp.int32))

    trt = StealRuntime(4, 64, {"x": torch.zeros((), dtype=torch.int32)},
                       policy=StealPolicy(**POLICY), device="cpu",
                       fault_plan=FaultPlan(**PLAN))
    trt.attach_detector(DetectorPolicy(suspect_after=2))
    tops = trt.ops

    def tbody(q, carry):
        q, _, n = tops.pop_bulk(q, 4, 2)
        return q, carry + n

    _seeded_drain(
        trt, lambda rt: rt.push(0, {"x": torch.arange(48, dtype=torch.int32)},
                                48),
        tbody, lambda: torch.zeros((4,), dtype=torch.int32))
    return jrt, trt


def test_runtime_metrics_match_the_jax_package(drained_runtimes):
    jrt, trt = drained_runtimes
    want, got = jm.runtime_metrics(jrt), trt.metrics()
    text = got.to_prometheus()
    assert COMPILED not in text and COMPILED not in got.snapshot()
    assert text == _without_compiled(want.to_prometheus())
    snap = want.snapshot()
    del snap[COMPILED]
    assert got.snapshot() == snap
    # the run exercised every collector branch
    values = got.snapshot()
    assert values["repro_dead_lanes"]["values"] == 1
    assert values["repro_fault_events_total"]["values"][
        '{kind="suspect"}'] >= 1
    assert values["repro_detector_lanes"]["values"]['{state="dead"}'] == 0
    assert values["repro_rounds_total"]["values"] == 7
    # collecting again into the same registry is idempotent
    assert tm.runtime_metrics(trt, got).to_prometheus() == text


class FakeReplica:
    """A model-free replica for both packages' ``ServeCluster``: each
    request gets ``max_new`` tokens at once."""

    def __init__(self, speed: float, wave_size: int = 3):
        self.speed, self.wave_size = speed, wave_size
        self.tokens_generated = 0

    def run_wave(self, wave):
        for r in wave:
            r.output = list(range(r.max_new))
            self.tokens_generated += r.max_new
        return wave


def _serve_script(cluster, request_cls):
    """Two bursts of requests through 3 replicas, one at a third of the
    speed; an eviction and re-admission between them."""
    cluster.submit([request_cls(prompt=[1], max_new=1 + i % 3, rid=i)
                    for i in range(14)])
    for _ in range(3):
        cluster.step()
    cluster.evict_replica(2)
    cluster.step()
    cluster.readmit_replica(2)
    cluster.submit([request_cls(prompt=[1], max_new=2, rid=100 + i)
                    for i in range(6)])
    for _ in range(40):
        if cluster.step() == 0 and all(r.load() == 0
                                       for r in cluster.master.replicas):
            break
    return cluster


@pytest.mark.parametrize("master", ["host", "device"])
def test_master_and_cluster_metrics_match_the_jax_package(master):
    inf = float("inf")
    if master == "host":
        masters = (JaxMaster(3, JaxPolicy(low_watermark=1, high_watermark=2)),
                   AdmissionMaster(3, StealPolicy(low_watermark=1,
                                                  high_watermark=2)))
    else:
        masters = (JaxDeviceMaster(3, capacity=32),
                   RuntimeAdmissionMaster(3, capacity=32, device="cpu"))
    reps = [[FakeReplica(s) for s in (1.0, 1.0, 0.34)] for _ in range(2)]
    want = _serve_script(JaxServeCluster(reps[0], masters[0],
                                         straggler_threshold=inf), JaxRequest)
    got = _serve_script(ServeCluster(reps[1], masters[1],
                                     straggler_threshold=inf), Request)
    assert got.master.stats()["stolen"] == want.master.stats()["stolen"] > 0
    for poll in (lambda c: c.metrics(), lambda c: c.master.metrics()):
        w, g = poll(want), poll(got)
        assert g.to_prometheus() == _without_compiled(w.to_prometheus())
        snap = w.snapshot()
        snap.pop(COMPILED, None)
        assert g.snapshot() == snap
    text = tm.master_metrics(got.master).to_prometheus()
    assert text == _without_compiled(
        jm.master_metrics(want.master).to_prometheus())
    served = got.metrics().snapshot()["repro_serve_served_total"]["values"]
    assert served == 20
    assert ('repro_serve_replica_tokens_total{replica="2"}'
            in got.metrics().to_prometheus())
    if master == "device":  # the backing runtime's lanes too
        assert "repro_queue_items 0" in got.master.metrics().to_prometheus()


def test_collect_paged_queue_matches_the_jax_package():
    jq = JaxPagedQueue(8, jax.ShapeDtypeStruct((), jnp.int32),
                       low_watermark=2)
    tq = PagedQueue(8, torch.zeros((), dtype=torch.int32), low_watermark=2,
                    device="cpu")
    texts = []
    for base in range(0, 24, 4):
        jq.push(jnp.arange(base, base + 4, dtype=jnp.int32), 4)
        tq.push(torch.arange(base, base + 4, dtype=torch.int32), 4)
    texts.append((jm.collect_paged_queue(jm.MetricsRegistry(), jq),
                  tm.collect_paged_queue(tm.MetricsRegistry(), tq)))
    for _ in range(17):  # through the refills
        jq.pop()
        tq.pop()
    texts.append((jm.collect_paged_queue(jm.MetricsRegistry(), jq),
                  tm.collect_paged_queue(tm.MetricsRegistry(), tq)))
    assert tq.spills > 0 and tq.refills > 0
    for want, got in texts:
        assert got.to_prometheus() == want.to_prometheus()
        assert got.snapshot() == want.snapshot()


def test_run_resilient_writes_a_throttled_textfile(tmp_path, monkeypatch):
    """``should_stop`` rewrites the textfile at most once per
    ``metrics_every_s`` of ``time.monotonic`` (0.4 s a call here), and
    the last write after the loop is the final poll."""
    now = [0.0]

    def tick():
        now[0] += 0.4
        return now[0]

    writes = []
    real = tm.write_textfile

    def counted(reg, path):
        writes.append(reg.snapshot()["repro_rounds_total"]["values"])
        real(reg, path)

    monkeypatch.setattr(resilient.time, "monotonic", tick)
    monkeypatch.setattr(tm, "write_textfile", counted)
    final = {}

    def make_runtime():
        rt = StealRuntime(4, 64, torch.zeros((), dtype=torch.int32),
                          policy=StealPolicy(**POLICY), device="cpu")
        rt.push(0, torch.arange(32, dtype=torch.int32), 32)
        return rt

    def drive(rt, should_stop):
        ops = rt.ops

        def body(q, carry):
            q, _, n = ops.pop_bulk(q, 4, 2)
            return q, carry + n

        while rt.total_size() > 0 and not should_stop():
            rt.round(body)
        final["rt"] = rt
        return rt.rounds_run

    path = tmp_path / "live.prom"
    rounds = resilient.run_resilient(make_runtime, drive,
                                     snapshot_dir=str(tmp_path / "snap"),
                                     metrics_path=str(path),
                                     metrics_every_s=1.0)
    assert rounds > 3
    text = path.read_text()
    assert text == final["rt"].metrics().to_prometheus()
    assert f"repro_rounds_total {rounds}" in text
    # the first poll writes, then every third (1.2 s >= 1.0 s), and the
    # final write after the loop: rounds + 1 polls of should_stop
    polls = rounds + 1
    assert len(writes) == len(range(0, polls, 3)) + 1
    assert writes[:-1] == list(range(0, polls, 3)) and writes[-1] == rounds
    assert sorted(p.name for p in tmp_path.iterdir()) == ["live.prom",
                                                          "snap"]
