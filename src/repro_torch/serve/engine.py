"""Wave-batched serving engine (port of ``repro.serve.engine``).

Each replica runs waves: pop up to ``wave_size`` requests from its queue
(bulk), left-pad prompts to a common length, one batched prefill (its
attention is K6 on the card), then batched greedy decode until every
request hits its ``max_new`` budget.  Between waves the replica yields to
the admission master's rebalance round (``serve/scheduler.py``).

The admission queues live on the host (``execution="host"``).  The JAX
package's ``"vmap"`` / ``"mesh"`` executions put them on executor lanes
through ``RuntimeAdmissionMaster``, which is not ported yet; they raise.
``ServeCluster.metrics()`` waits for the observability slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.runtime.detector import DetectorPolicy, FailureDetector
from repro_torch.serve.kv_cache import pad_cache
from repro_torch.serve.scheduler import AdmissionMaster, Request
from repro_torch.train.fault import StragglerMonitor

__all__ = ["Replica", "ServeCluster"]


class Replica:
    """One model replica: ``model`` with ``params`` (on the device the
    replica serves from)."""

    def __init__(self, model, params, *, wave_size: int = 4,
                 max_seq: int = 128):
        self.model = model
        self.params = params
        self.wave_size = wave_size
        self.max_seq = max_seq
        self.device = params["embed"].device
        # ring-aware growth when the model provides it (local/SWA caches)
        self._grow = getattr(model, "grow_cache", None) or pad_cache
        self.tokens_generated = 0
        self.speed = 1.0   # straggler simulation hook (tests scale this)

    def run_wave(self, wave: List[Request]) -> List[Request]:
        if not wave:
            return []
        B = len(wave)
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(wave):  # left-pad with 0
            toks[i, plen - len(r.prompt):] = r.prompt
        logits, cache = self.model.prefill(
            self.params, torch.from_numpy(toks).to(self.device))
        cache = self._grow(cache, self.max_seq)  # head room for decode
        out = [[] for _ in range(B)]
        cur = logits[:, -1].argmax(dim=-1).to(torch.int32)
        max_new = max(r.max_new for r in wave)
        for _ in range(min(max_new, self.max_seq - plen)):
            for i, t in enumerate(cur.tolist()):
                out[i].append(t)
            logits, cache = self.model.decode_step(self.params, cache,
                                                   cur[:, None])
            cur = logits[:, -1].argmax(dim=-1).to(torch.int32)
            self.tokens_generated += B
        for i, r in enumerate(wave):
            r.output = out[i][: r.max_new]
        return wave


class ServeCluster:
    """N replicas + one admission master; ``step()`` = each replica runs
    one wave, then the master rebalances (the superstep structure of
    ``core.master``, at host level).  ``rebalance_rounds > 1`` lets the
    master run several steal rounds per wave tick
    (``AdmissionMaster.rebalance_many``).

    Waves flow through the master's telemetry stream: each tick appends
    one :class:`~repro_torch.runtime.telemetry.WaveRecord` (requests
    served, tokens generated, post-wave per-replica loads) next to the
    round records.

    Straggler escalation is the shared failure detector's: every slow wave
    SUSPECTS the replica (straggler boost via ``note_straggler``); a
    replica slow ``auto_evict_after`` waves IN A ROW is declared DEAD and
    evicted, its queue drained onto the others.  ``None`` keeps the
    boost-only behaviour."""

    def __init__(self, replicas: List[Replica],
                 master: Optional[AdmissionMaster] = None,
                 rebalance_rounds: int = 1,
                 execution: str = "host",
                 straggler_threshold: float = 2.0,
                 auto_evict_after: Optional[int] = None):
        if execution != "host":
            raise NotImplementedError(
                f"execution={execution!r} needs RuntimeAdmissionMaster "
                f"(admission queues on executor lanes), which is not "
                f"ported yet; use execution='host'")
        self.replicas = replicas
        self.master = master or AdmissionMaster(len(replicas))
        self.rebalance_rounds = int(rebalance_rounds)
        self.done: List[Request] = []
        # One wall-clock straggler monitor per replica; its timeout
        # observations feed the shared FailureDetector below.
        self.monitors = [StragglerMonitor(threshold=straggler_threshold)
                         for _ in replicas]
        self.auto_evict_after = auto_evict_after
        pol = DetectorPolicy(suspect_after=1, dead_after=auto_evict_after,
                             healthy_after=1)
        attach = getattr(self.master, "attach_detector", None)
        if attach is not None:
            self.detector = attach(pol)
        else:  # duck-typed custom master: boost-only wiring
            self.detector = FailureDetector(
                len(replicas), pol,
                on_suspect=lambda rid: self.master.note_straggler(),
                on_dead=self._auto_evict)

    def _auto_evict(self, replica_id: int) -> None:
        self.evict_replica(replica_id)
        self.telemetry.record_fault("auto_evict")

    def evict_replica(self, replica_id: int) -> int:
        """Planned eviction: the master drains the replica's queued
        requests onto the other replicas; the replica receives no further
        waves until :meth:`readmit_replica`.  Returns the number of
        requests drained."""
        return self.master.evict(replica_id)

    def readmit_replica(self, replica_id: int) -> None:
        self.master.readmit(replica_id)
        # Masters with an attached detector revive it in readmit();
        # revive the engine-owned fallback detector ourselves.
        if getattr(self.master, "detector", None) is not self.detector:
            self.detector.revive(replica_id)

    @property
    def telemetry(self):
        """The unified per-round + per-wave telemetry stream (the
        admission master's ``runtime.telemetry.Telemetry``)."""
        return self.master.telemetry

    def submit(self, reqs: List[Request]):
        self.master.submit(reqs)

    def step(self) -> int:
        served = 0
        stragglers = 0
        tokens_before = sum(r.tokens_generated for r in self.replicas)
        for rid, rep in enumerate(self.replicas):
            rq = self.master.replicas[rid]
            if getattr(rq, "evicted", False):
                continue  # drained and masked out; no new waves
            # straggler simulation: slow replicas take smaller waves
            wave_n = max(1, int(rep.wave_size * rep.speed))
            mon = self.monitors[rid]
            mon.start()
            wave = rq.pop_wave(wave_n)
            finished = rep.run_wave(wave)
            slow = bool(mon.observe()) and bool(wave)
            if slow:
                stragglers += 1
            # The wave's requests are accounted BEFORE the detector may
            # escalate to eviction — nothing in flight is lost.
            rq.finish_wave(len(finished))
            self.done.extend(finished)
            served += len(finished)
            if wave:  # empty waves say nothing about replica health
                self.detector.observe(rid, slow)
        tokens = sum(r.tokens_generated for r in self.replicas) - tokens_before
        evicted = sum(1 for r in self.master.replicas
                      if getattr(r, "evicted", False))
        self.telemetry.record_wave(
            loads=[r.load() for r in self.master.replicas],
            served=served, tokens=tokens,
            evicted=evicted, stragglers=stragglers)
        self.master.rebalance_many(self.rebalance_rounds)
        return served

    def run_until_drained(self, max_steps: int = 1000) -> List[Request]:
        for _ in range(max_steps):
            pending = sum(r.load() for r in self.master.replicas)
            if pending == 0:
                break
            self.step()
        return self.done
