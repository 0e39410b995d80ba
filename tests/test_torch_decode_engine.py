"""The port's continuous-batching decode engine (``repro_torch.serve
.decode``) and device-resident admission (``repro_torch.distributed
.serve``) on the CPU, on reduced llama3.2-1b in float32 with the JAX
package's parameters (``tests/_torch_decode.py``):

* the port's counterparts of ``tests/test_decode.py``: tokens equal to a
  plain batch-1 greedy decode under every scheduler, same-round slot and
  page reuse, page-pressure back-pressure, migration with pages, the
  static baseline, the SLO stream and the straggler wiring;
* ``ServeCluster(execution="vmap")`` and ``RuntimeAdmissionMaster``
  against the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.distributed.serve import RuntimeAdmissionMaster as JaxMaster
from repro.serve.decode import DecodeCluster as JaxCluster
from repro.serve.engine import Replica as JaxReplica
from repro.serve.engine import ServeCluster as JaxServeCluster
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.distributed import RuntimeAdmissionMaster
from repro_torch.serve.decode import (DecodeCluster, DecodePolicy,
                                      encode_requests, request_spec)
from repro_torch.serve.engine import Replica, ServeCluster
from repro_torch.serve.scheduler import Request

from _torch_decode import INF, models  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401


# ------------------------------------- tests/test_decode.py's counterparts


def _reference(model, params, prompt, max_new):
    """Greedy decode, one token at a time, no paging, no batching."""
    cache = model.make_cache(1, len(prompt) + max_new, device="cpu")
    cur = None
    for t in prompt:
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[t]], dtype=torch.int32))
        cur = int(logits[0, 0].argmax())
    out = [cur]
    for _ in range(max_new - 1):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[out[-1]]], dtype=torch.int32))
        out.append(int(logits[0, 0].argmax()))
    return out


def _mix(n, seed=0, max_prompt=8, max_new=6):
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(1, 100, size=int(
        rng.integers(1, max_prompt))))), int(rng.integers(1, max_new)))
            for _ in range(n)]


POL = DecodePolicy(n_slots=3, max_prompt=8, max_new=6, page_size=4)


def _cluster(models, pol=POL, **kw):
    _, tm, _, tp = models
    kw.setdefault("straggler_threshold", INF)
    return DecodeCluster(tm, tp, policy=pol, device="cpu", **kw)


def _multiset(models, data):
    _, tm, _, tp = models
    return sorted(tuple(_reference(tm, tp, p, mn)) for p, mn in data)


def test_decode_matches_reference(models):
    _, tm, _, tp = models
    data = _mix(8, seed=1)
    cluster = _cluster(models, n_lanes=2, capacity=16, execution="vmap")
    reqs = [Request(prompt=p, max_new=mn) for p, mn in data]
    cluster.submit(reqs)
    done = cluster.run_until_drained(max_steps=200)
    assert len(done) == len(data)
    by_rid = {r.rid: r.output for r in done}
    for r, (p, mn) in zip(reqs, data):
        assert by_rid[r.rid] == _reference(tm, tp, p, mn), r.rid


def test_host_execution_and_host_stealing(models):
    data = _mix(10, seed=2)
    c = _cluster(models, n_lanes=4, capacity=16, execution="host",
                 admission="rr")
    # imbalance the admission so the host master has something to steal
    c.admission = "load"
    c._loads[:] = [0, 10**6, 10**6, 10**6]   # all to lane 0
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    done = c.run_until_drained(max_steps=200)
    assert len(done) == 10
    assert c.stolen > 0                       # host plan moved queued work
    assert sorted(tuple(r.output) for r in done) == _multiset(models, data)


def test_continuous_batching_reuses_slots_same_round(models):
    """More requests than total slots drain anyway: finished sequences
    free their slot and pages in the same round new work is seated."""
    data = _mix(12, seed=3)
    c = _cluster(models, n_lanes=2, capacity=32, execution="vmap",
                 balance=False, admission="rr")
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    assert 12 > 2 * POL.n_slots               # oversubscribed by design
    done = c.run_until_drained(max_steps=300)
    assert len(done) == 12
    st = c.stats()                            # every page returned
    assert all(k == 0 for k in st["kv_tokens"])
    assert not c.carry["active"].any()
    assert int(c.carry["n_alloc"].sum()) == 0


def test_page_pressure_backpressures_but_drains(models):
    """A pool smaller than the slots' worst case admits fewer sequences at
    a time, counts stalls, and still drains."""
    pol = dataclasses.replace(POL, n_pages=4)  # 1 sequence's worth
    data = _mix(10, seed=4)
    c = _cluster(models, pol, n_lanes=2, capacity=32, execution="vmap",
                 admission="rr")
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    done = c.run_until_drained(max_steps=1000)
    assert len(done) == 10
    assert c.stats()["stalls"] > 0
    assert sorted(tuple(r.output) for r in done) == _multiset(models, data)


def test_migrate_steals_inflight_with_pages(models):
    pol = dataclasses.replace(POL, steal="migrate", migrate_threshold=1.2)
    data = _mix(10, seed=5)
    c = _cluster(models, pol, n_lanes=2, capacity=32, execution="vmap",
                 admission="load")
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    done = c.run_until_drained(max_steps=300)
    assert len(done) == 10
    assert c.migrated > 0                     # the expensive path ran
    assert sorted(tuple(r.output) for r in done) == _multiset(models, data)
    assert sum(w.migrated for w in c.telemetry.waves) == c.migrated


def test_static_baseline_never_steals(models):
    c = _cluster(models, n_lanes=2, capacity=16, execution="vmap",
                 balance=False, admission="rr")
    data = _mix(8, seed=6)
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    c.run_until_drained(max_steps=200)
    assert c.stolen == 0 and c.migrated == 0
    assert c.controller is None


def test_slo_stream_and_token_loads(models):
    c = _cluster(models, n_lanes=2, capacity=16, execution="vmap")
    data = _mix(6, seed=7)
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    # submit-time load estimate is true token cost, not request count
    assert c._loads.sum() == sum(len(p) + mn for p, mn in data)
    c.run_until_drained(max_steps=200)
    tele = c.telemetry
    assert len(tele.requests) == 6
    for r in tele.requests:
        assert 0 <= r.admit <= r.first <= r.finish
        assert r.ttft == r.first - r.admit
        assert r.latency == r.finish - r.admit
        assert r.tokens >= 1
    assert tele.total_tokens == sum(r.tokens for r in tele.requests)
    summ = tele.summary()
    assert summ["ttft_p50"] <= summ["ttft_p99"] <= summ["latency_p99"]


def test_encode_requests_validates():
    pol = DecodePolicy(n_slots=2, max_prompt=4, max_new=4)
    with pytest.raises(ValueError, match="prompt length"):
        encode_requests([Request(prompt=[1] * 5, max_new=2)], pol, 0,
                        device="cpu")
    with pytest.raises(ValueError, match="max_new"):
        encode_requests([Request(prompt=[1], max_new=9)], pol, 0,
                        device="cpu")
    batch = encode_requests([Request(prompt=[1, 2], max_new=3)], pol, 7,
                            device="cpu")
    assert int(batch["plen"][0]) == 2 and int(batch["admit"][0]) == 7
    spec = request_spec(pol)
    assert tuple(batch["prompt"].shape) == (1,) + tuple(
        spec["prompt"].shape)
    assert all(t.dtype == torch.int32 for t in batch.values())


def test_decode_straggler_wiring(models):
    """A flagged slow step feeds telemetry AND boosts the steal proportion
    through the token-load controller."""
    c = _cluster(models, n_lanes=2, capacity=16, execution="vmap")
    base = c.controller.effective_proportion
    c.note_straggler(rounds=3, factor=2.0)
    assert c.telemetry.straggler_steps == 1
    assert c.controller.effective_proportion > base
    data = _mix(4, seed=8)
    c.submit([Request(prompt=p, max_new=mn) for p, mn in data])
    done = c.run_until_drained(max_steps=100)
    assert len(done) == 4                     # boost decays, serving fine
    # the JAX DecodeCluster has no metrics(), and the port adds none
    assert not hasattr(JaxCluster, "metrics")
    assert not hasattr(c, "metrics")


def test_decode_refuses_bad_arguments(models):
    with pytest.raises(ValueError, match="execution"):
        _cluster(models, execution="threads")
    with pytest.raises(ValueError, match="admission"):
        _cluster(models, admission="random")
    with pytest.raises(ValueError, match="steal"):
        DecodePolicy(steal="everything")
    c = _cluster(models, n_lanes=1, capacity=2, execution="vmap")
    with pytest.raises(RuntimeError, match="admission ring overflow"):
        c.submit([Request(prompt=[1], max_new=1) for _ in range(3)])


# ------------------------------------------------ device-resident admission


def test_serve_cluster_on_executor_lanes_matches_the_jax_package(models):
    """ServeCluster(execution="vmap"): the request-id rings on stacked
    executor lanes.  Equal-length prompts, so a request's tokens are its
    own whatever its wave mates (see tests/test_torch_serve.py)."""
    jm, tm, jp, tp = models
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, 512, 6))) for _ in range(10)]
    budgets = [int(rng.integers(2, 5)) for _ in prompts]

    def run(replica, cluster_cls, request_cls, model, params):
        reps = [replica(model, params, wave_size=3, max_seq=16)
                for _ in range(2)]
        reps[0].speed = 0.34   # waves of one: the master has to steal
        c = cluster_cls(reps, execution="vmap", admission_capacity=32,
                        straggler_threshold=INF)
        c.submit([request_cls(prompt=p, max_new=n, rid=i)
                  for i, (p, n) in enumerate(zip(prompts, budgets))])
        done = c.run_until_drained()
        st = c.master.stats()
        return ({r.rid: list(r.output) for r in done},
                {k: st[k] for k in ("completed", "stolen", "rounds",
                                    "queued", "evicted")},
                c.telemetry.summary())

    got, want = (run(Replica, ServeCluster, Request, tm, tp),
                 run(JaxReplica, JaxServeCluster, JaxRequest, jm, jp))
    assert got[0] == want[0] and sorted(got[0]) == list(range(10))
    assert got[1] == want[1] and got[1]["stolen"] > 0
    for key in ("rounds", "steals", "items_transferred", "served", "tokens",
                "proportion_final"):
        assert got[2][key] == want[2][key], key


def _master_script(master, request_cls):
    """Admission, waves, rebalancing, eviction and re-admission through a
    device master; what it observed on the way."""
    seen = []
    for i in range(3):
        master.submit([request_cls(prompt=[1], max_new=1, rid=10 * i + j)
                       for j in range(7)])
        seen.append(master.stats()["queued"])
    seen.append([r.rid for r in master.replicas[0].pop_wave(4)])
    seen.append(master.rebalance_many(3))
    seen.append(master.stats()["queued"])
    seen.append(master.evict(1))
    seen.append(master.stats()["queued"])
    master.readmit(1)
    master.note_straggler(rounds=2, factor=2.0, lane=1)
    seen.append(master.rebalance())
    st = master.stats()
    seen.append({k: st[k] for k in ("loads", "queued", "completed",
                                    "evicted", "stolen", "rounds",
                                    "proportion")})
    seen.append([r.rid for r in master.replicas[2].pop_wave(8)])
    seen.append(master.telemetry.summary()["faults"])
    return seen


def test_runtime_admission_master_matches_the_jax_package():
    tmaster = RuntimeAdmissionMaster(4, capacity=32, device="cpu")
    jmaster = JaxMaster(4, capacity=32)
    got = _master_script(tmaster, Request)
    want = _master_script(jmaster, JaxRequest)
    assert got == want
    # its metrics: the JAX text but the round jit-cache gauge, which the
    # port does not export
    text = tmaster.metrics().to_prometheus()
    assert text == "".join(
        line + "\n" for line in jmaster.metrics().to_prometheus().splitlines()
        if "repro_compiled_programs" not in line)
    assert "repro_compiled_programs" not in text
    assert "repro_serve_stolen_total" in text and "repro_lanes 4" in text
    master = RuntimeAdmissionMaster(2, capacity=8, device="cpu")
    assert master.runtime.fault is not None
    with pytest.raises(RuntimeError, match="overflow"):
        master.submit([Request(prompt=[1]) for _ in range(9)])
    det = master.attach_detector()
    assert master.detector is det
    assert RuntimeAdmissionMaster(2, capacity=8, device="cpu",
                                  elastic=False).runtime.fault is None
