"""Serving scheduler: per-replica request queues + single-master bulk
steal (port of ``repro.serve.scheduler``).

The paper's master-worker discipline applied to inference admission:

* each model REPLICA owns a request queue (one owner: the replica's
  engine loop popping work; one stealer: the admission master);
* new requests are admitted in BULK to the least-loaded replica (one
  splice — constant latency in the batch size, Fig. 6's property);
* when a replica drains below the low watermark while another is above
  the high watermark, the master steals ``proportion`` of the busy
  replica's TAIL — the oldest requests, which preserves the busy
  replica's locality with its in-flight wave (the paper's
  locality-aware redistribution argument, §II.B).

Queues are host-level and pluggable behind the
:class:`repro_torch.core.host_queue.HostQueue` protocol; the default is
the faithful paper port (``LinkedWSQueue``).  The master servos its
proportion with the SAME float32 feedback step (``adaptive_update``) the
device executor runs, and logs per-round steal counts and depth
histograms in the runtime's telemetry.  ``rebalance_many(k)`` mirrors the
executor's fused supersteps at host level: k rounds per controller tick,
stopping early once a round moves nothing.  ``metrics()`` (Prometheus
exposition) waits for the observability slice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.host_queue import HostQueue, LinkedWSQueue
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime.adaptive import AdaptiveConfig, AdaptiveController
from repro_torch.runtime.telemetry import Telemetry

__all__ = ["Request", "ReplicaQueue", "AdmissionMaster"]

_ids = itertools.count()


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new: int = 16
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    output: Optional[List[int]] = None


class ReplicaQueue:
    def __init__(self, replica_id: int,
                 queue_factory: Callable[[], HostQueue] = LinkedWSQueue):
        self.replica_id = replica_id
        self.q: HostQueue = queue_factory()
        self.in_flight = 0
        self.completed = 0
        self.evicted = False

    def load(self) -> int:
        return len(self.q) + self.in_flight

    def pop_wave(self, max_wave: int) -> List[Request]:
        wave = []
        while len(wave) < max_wave:
            r = self.q.pop_item()
            if r is None:
                break
            wave.append(r)
        self.in_flight += len(wave)
        return wave

    def finish_wave(self, n: int):
        self.in_flight -= n
        self.completed += n


class AdmissionMaster:
    """The single stealer + admission router."""

    def __init__(self, n_replicas: int, policy: Optional[StealPolicy] = None,
                 adaptive: bool = True,
                 adaptive_config: Optional[AdaptiveConfig] = None,
                 queue_factory: Callable[[], HostQueue] = LinkedWSQueue):
        self.replicas = [ReplicaQueue(i, queue_factory)
                         for i in range(n_replicas)]
        self.policy = policy or StealPolicy(proportion=0.5,
                                            low_watermark=1,
                                            high_watermark=8)
        self.controller = (AdaptiveController(self.policy, adaptive_config)
                           if adaptive else None)
        self.telemetry = Telemetry()  # item_bytes unknown host-side: counts
        self.stolen = 0
        self.rounds = 0
        # Automatic failure detection (attach_detector): None = off.
        self.detector = None

    @property
    def proportion(self) -> float:
        return (self.controller.effective_proportion if self.controller
                else self.policy.proportion)

    # -- admission -----------------------------------------------------------

    def submit(self, requests: Sequence[Request]) -> int:
        """Bulk-admit to the least-loaded replica (ONE splice)."""
        live = [r for r in self.replicas if not r.evicted]
        if not live:
            raise RuntimeError("every replica is evicted; nothing can admit")
        target = min(live, key=lambda r: r.load())
        # push_bulk's deque convention (later = newer): the engine pops
        # the newest request first while the oldest sit at the tail —
        # exactly what the master's locality-preserving tail steal wants.
        target.q.push_bulk(list(requests))
        return target.replica_id

    # -- planned eviction ----------------------------------------------------

    def evict(self, replica_id: int) -> int:
        """Planned eviction: drain replica ``replica_id``'s whole queue
        onto the least-loaded live replica (the host analogue of the
        executors' proportion-1.0 recovery plan), then mark it out of
        admission and rebalancing.  The drain is OWNER-side (pop + one
        bulk splice): a stealer-side proportion-1.0 cut skips zero nodes,
        which the §IV interference guard always aborts — and eviction is
        the master acting on a queue it owns, not a racing stealer.
        In-flight requests finish where they are; the engine stops
        handing the replica new waves.  Returns the number of requests
        drained."""
        victim = self.replicas[replica_id]
        live = [r for r in self.replicas
                if not r.evicted and r.replica_id != replica_id]
        if not live:
            raise RuntimeError("cannot evict the last live replica")
        items = []
        while True:
            item = victim.q.pop_item()
            if item is None:
                break
            items.append(item)
        items.reverse()  # pops came newest-first; re-push oldest-first
        if items:
            target = min(live, key=lambda r: r.load())
            target.q.push_bulk(items)
        victim.evicted = True
        self.telemetry.record_fault("evict")
        return len(items)

    def readmit(self, replica_id: int) -> None:
        """Re-admit an evicted replica: it rejoins admission and the
        idle side of rebalancing from the next round, with any detector
        state and straggler penalty cleared (clean bill of health)."""
        self.replicas[replica_id].evicted = False
        if self.detector is not None:
            self.detector.revive(replica_id)
        if self.controller is not None:
            self.controller.clear_straggler(replica_id)
        self.telemetry.record_fault("readmit")

    def note_straggler(self, rounds: int = 4, factor: float = 1.5,
                       lane: Optional[int] = None) -> None:
        """A replica was flagged slow: count it and temporarily boost the
        steal proportion (same response the device runtime applies).
        ``lane`` attributes the boost so :meth:`readmit` can clear it."""
        self.telemetry.record_fault("straggler")
        if self.controller is not None:
            self.controller.flag_straggler(rounds=rounds, factor=factor,
                                           lane=lane)

    def attach_detector(self, policy=None):
        """Arm the shared :class:`repro_torch.runtime.detector.FailureDetector`
        escalation policy on this master: a SUSPECTED replica gets the
        straggler proportion boost, a DEAD one a real :meth:`evict`
        (recorded as ``auto_evict``).  The owner feeds observations
        (``master.detector.observe(rid, slow)``); :meth:`readmit`
        revives.  Returns the detector (also at :attr:`detector`)."""
        from repro_torch.runtime.detector import DetectorPolicy, FailureDetector

        pol = policy or DetectorPolicy()

        def on_suspect(rid: int) -> None:
            self.note_straggler(rounds=pol.boost_rounds,
                                factor=pol.boost_factor, lane=rid)

        def on_dead(rid: int) -> None:
            if not self.replicas[rid].evicted:
                self.evict(rid)
                self.telemetry.record_fault("auto_evict")

        def on_revive(rid: int) -> None:
            if self.controller is not None:
                self.controller.clear_straggler(rid)

        self.detector = FailureDetector(len(self.replicas), pol,
                                        on_suspect=on_suspect,
                                        on_dead=on_dead,
                                        on_revive=on_revive)
        return self.detector

    # -- rebalancing ---------------------------------------------------------

    def rebalance(self) -> int:
        """One master round: pair drained replicas with overloaded ones and
        bulk-steal the victim's tail.  At most one steal per victim per
        round (single-stealer invariant).  Evicted replicas are neither
        thieves nor victims."""
        self.rounds += 1
        pol = self.policy
        proportion = self.proportion
        idle = sorted((r for r in self.replicas
                       if not r.evicted and len(r.q) <= pol.low_watermark),
                      key=lambda r: r.load())
        busy = sorted((r for r in self.replicas
                       if not r.evicted and len(r.q) >= pol.high_watermark),
                      key=lambda r: -len(r.q))
        moved = 0
        n_steals = 0
        for thief, victim in zip(idle, busy):
            stolen = victim.q.steal_bulk(proportion)
            if not stolen:
                continue
            thief.q.push_bulk(stolen)
            moved += len(stolen)
            n_steals += 1
        self.stolen += moved
        sizes = [len(r.q) for r in self.replicas]
        self.telemetry.record(sizes=sizes, n_steals=n_steals,
                              n_transferred=moved, proportion=proportion)
        if self.controller is not None:
            self.controller.update(sizes)
        return moved

    def rebalance_many(self, k: int) -> int:
        """Run up to ``k`` rebalance rounds in one controller tick (the
        host-level analogue of ``StealRuntime.run_fused``), stopping
        early once a round moves nothing — a severely imbalanced cluster
        converges in one tick instead of one round per tick.  Returns
        total requests moved."""
        moved = 0
        for _ in range(k):
            step = self.rebalance()
            moved += step
            if step == 0:
                break
        return moved

    def stats(self) -> Dict:
        return {
            "loads": [r.load() for r in self.replicas],
            "queued": [len(r.q) for r in self.replicas],
            "completed": [r.completed for r in self.replicas],
            "evicted": [r.replica_id for r in self.replicas if r.evicted],
            "stolen": self.stolen,
            "rounds": self.rounds,
            "proportion": self.proportion,
            "telemetry": self.telemetry.summary(),
        }
