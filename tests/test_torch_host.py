"""The port's host-side serving pieces against the JAX package: the paper's
host queue (Listings 1-4) and its baselines, the failure detector, the
adaptive controller's straggler boost, wave telemetry and the admission
master.  All of it is framework-free bookkeeping, so everything must be
equal: contents, counts, states, float32 proportions and summaries."""

import numpy as np
import pytest

from repro.core import host_queue as jhq
from repro.core.policy import StealPolicy as JaxPolicy
from repro.runtime.adaptive import AdaptiveController as JaxController
from repro.runtime.detector import DetectorPolicy as JaxDetectorPolicy
from repro.runtime.detector import FailureDetector as JaxDetector
from repro.runtime.telemetry import Telemetry as JaxTelemetry
from repro.serve.scheduler import AdmissionMaster as JaxMaster
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.core import host_queue as hq
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime.adaptive import AdaptiveController
from repro_torch.runtime.detector import DetectorPolicy, FailureDetector
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.serve.scheduler import AdmissionMaster, Request

from _torch_parity import one_torch_thread  # noqa: F401

QUEUES = ["LinkedWSQueue", "PerItemDequeQueue", "ResizingArrayQueue"]


def _contents(q):
    """Pop everything, newest first."""
    out = []
    while len(q):
        out.append(q.pop_item())
    return out


@pytest.mark.parametrize("name", QUEUES)
@pytest.mark.parametrize("seed", range(3))
def test_host_queue_op_programs_match(name, seed):
    rng = np.random.default_rng(seed)
    mine, theirs = getattr(hq, name)(), getattr(jhq, name)()
    nxt = 0
    for _ in range(200):
        op = rng.integers(4)
        if op == 0:
            n = int(rng.integers(0, 40))
            batch = list(range(nxt, nxt + n))
            nxt += n
            mine.push_bulk(batch)
            theirs.push_bulk(batch)
        elif op == 1:
            assert mine.pop_item() == theirs.pop_item()
        elif op == 2:
            p = float(rng.choice([0.1, 0.25, 0.5, 0.6, 0.9]))
            assert mine.steal_bulk(p) == theirs.steal_bulk(p)
        else:
            prepared = (mine.make_batch(range(nxt, nxt + 5)),
                        theirs.make_batch(range(nxt, nxt + 5)))
            nxt += 5
            mine.push_batch(prepared[0])
            theirs.push_batch(prepared[1])
        assert len(mine) == len(theirs)
    assert _contents(mine) == _contents(theirs)


@pytest.mark.parametrize("seed", range(3))
def test_listing4_steal_variants_match(seed):
    """Both of Listing 4's steals (non-optimized and §IV optimized), with
    their (begin, end, count) results, on the native linked lists."""
    rng = np.random.default_rng(seed)
    mine, theirs = hq.LinkedWSQueue(), jhq.LinkedWSQueue()
    for step in range(100):
        items = list(range(step * 50, step * 50 + int(rng.integers(0, 50))))
        mine.push(hq.llist_from_iter(items))
        theirs.push(jhq.llist_from_iter(items))
        p = float(rng.choice([0.2, 0.5, 0.8]))
        fn = "steal" if rng.integers(2) else "steal_optimized"
        a, b = getattr(mine, fn)(p), getattr(theirs, fn)(p)
        assert a[2] == b[2]
        assert (a[0] is None) == (b[0] is None)
        walk = []
        for node in (a[0], b[0]):
            vals = []
            while node is not None:
                vals.append(node.payload)
                node = node.next
            walk.append(vals)
        assert walk[0] == walk[1]
        assert len(mine) == len(theirs)
    assert mine.drain() == theirs.drain()
    assert isinstance(mine, hq.HostQueue)


@pytest.mark.parametrize("seed", range(4))
def test_failure_detector_traces_match(seed):
    rng = np.random.default_rng(seed)
    kw = dict(suspect_after=int(rng.integers(1, 3)),
              dead_after=[None, 4, 6][seed % 3], healthy_after=2,
              wall_window=8)
    events = ([], [])

    def detector(cls, pol_cls, log):
        return cls(3, pol_cls(**kw),
                   on_suspect=lambda l: log.append(("suspect", l)),
                   on_dead=lambda l: log.append(("dead", l)),
                   on_revive=lambda l: log.append(("revive", l)))

    mine = detector(FailureDetector, DetectorPolicy, events[0])
    theirs = detector(JaxDetector, JaxDetectorPolicy, events[1])
    for _ in range(150):
        lane = int(rng.integers(3))
        op = rng.integers(10)
        if op < 6:
            slow = bool(rng.random() < 0.6)
            assert mine.observe(lane, slow) == theirs.observe(lane, slow)
        elif op < 9:
            wall = float(rng.choice([1.0, 1.1, 5.0]))
            assert (mine.observe_wall(lane, wall)
                    == theirs.observe_wall(lane, wall))
        else:
            mine.revive(lane)
            theirs.revive(lane)
        assert mine.states() == theirs.states()
        assert mine.streak(lane) == theirs.streak(lane)
    assert events[0] == events[1]
    with pytest.raises(ValueError):
        DetectorPolicy(suspect_after=3, dead_after=2)


def test_straggler_boost_matches():
    pol = StealPolicy(proportion=0.5, low_watermark=1, high_watermark=2)
    jpol = JaxPolicy(proportion=0.5, low_watermark=1, high_watermark=2)
    mine, theirs = AdaptiveController(pol), JaxController(jpol)
    rng = np.random.default_rng(0)
    for step in range(40):
        if step % 7 == 0:
            kw = dict(rounds=int(rng.integers(1, 5)), factor=1.7,
                      lane=int(rng.integers(3)))
            mine.flag_straggler(**kw)
            theirs.flag_straggler(**kw)
        if step % 11 == 5:
            mine.clear_straggler(step % 3)
            theirs.clear_straggler(step % 3)
        sizes = rng.integers(0, 10, 4)
        assert mine.update(sizes) == theirs.update(sizes)
        assert mine.effective_proportion == theirs.effective_proportion
    assert mine.history == theirs.history


def test_wave_telemetry_matches():
    mine, theirs = Telemetry(), JaxTelemetry()
    for t in (mine, theirs):
        t.record(sizes=[3, 0, 5], n_steals=1, n_transferred=2,
                 proportion=0.5)
        t.record_fault("straggler", lane=1)
        t.record_wave(loads=[1, 2, 3], served=2, tokens=16, stragglers=1)
        for rid in range(5):
            t.record_request(rid=rid, admit=rid, first=rid + 2,
                             finish=rid + 3 + rid % 4, tokens=4)
        t.record_wave(loads=[0, 0, 1], served=3, tokens=12, evicted=1,
                      migrated=2)
        t.record_fault("evict")
    assert [vars(w) for w in mine.waves] == [vars(w) for w in theirs.waves]
    assert mine.summary() == theirs.summary()
    assert mine.fault_log == theirs.fault_log


def _masters(policy_kw):
    return (AdmissionMaster(3, StealPolicy(**policy_kw)),
            JaxMaster(3, JaxPolicy(**policy_kw)))


@pytest.mark.parametrize("seed", range(3))
def test_admission_master_programs_match(seed):
    """Submit, serve waves, rebalance (one and many rounds), straggler
    flags, detector-driven eviction and re-admission: the same requests
    end in the same places and ``stats()`` agrees exactly."""
    rng = np.random.default_rng(seed)
    mine, theirs = _masters(dict(proportion=0.5, low_watermark=1,
                                 high_watermark=2))
    dets = (mine.attach_detector(DetectorPolicy(suspect_after=1,
                                                dead_after=3)),
            theirs.attach_detector(JaxDetectorPolicy(suspect_after=1,
                                                     dead_after=3)))
    rid = 0
    for _ in range(60):
        op = rng.integers(6)
        if op == 0:
            n = int(rng.integers(1, 12))
            got = mine.submit([Request(prompt=[1], rid=rid + i)
                               for i in range(n)])
            want = theirs.submit([JaxRequest(prompt=[1], rid=rid + i)
                                  for i in range(n)])
            assert got == want
            rid += n
        elif op == 1:
            r = int(rng.integers(3))
            if not mine.replicas[r].evicted:
                k = int(rng.integers(1, 5))
                a = mine.replicas[r].pop_wave(k)
                b = theirs.replicas[r].pop_wave(k)
                assert [x.rid for x in a] == [x.rid for x in b]
                mine.replicas[r].finish_wave(len(a))
                theirs.replicas[r].finish_wave(len(b))
        elif op == 2:
            assert mine.rebalance() == theirs.rebalance()
        elif op == 3:
            k = int(rng.integers(1, 4))
            assert mine.rebalance_many(k) == theirs.rebalance_many(k)
        elif op == 4:
            r, slow = int(rng.integers(3)), bool(rng.random() < 0.7)
            if sum(not x.evicted for x in mine.replicas) > 1 or not slow:
                assert dets[0].observe(r, slow) == dets[1].observe(r, slow)
        else:
            r = int(rng.integers(3))
            if mine.replicas[r].evicted:
                mine.readmit(r)
                theirs.readmit(r)
        assert mine.stats() == theirs.stats()
    st = mine.stats()
    assert st["stolen"] > 0 and st["telemetry"]["straggler_steps"] > 0
    for a, b in zip(mine.replicas, theirs.replicas):
        assert ([x.rid for x in _contents(a.q)]
                == [x.rid for x in _contents(b.q)])


def test_evicting_the_last_live_replica_raises():
    m = AdmissionMaster(2)
    m.evict(0)
    with pytest.raises(RuntimeError, match="last live replica"):
        m.evict(1)
