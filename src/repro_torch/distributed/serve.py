"""Device-resident admission: the serving master's queues AS executor lanes
(PyTorch port of ``repro.distributed.serve``).

The host :class:`~repro_torch.serve.scheduler.AdmissionMaster` keeps
request queues in Python objects and runs the steal plan in a loop.
:class:`RuntimeAdmissionMaster` swaps them for executor lanes holding
request IDs (4 bytes a request): one ring per replica, admission is one
bulk push (K2), a replica's wave is one bulk pop (K3), and every
rebalance round is a real superstep (K1 window, K4 splice) through
:func:`repro_torch.distributed.launch_runtime` — the W lanes stacked on one
device (``execution="vmap"``) or one lane per process
(``execution="mesh"``).  Request payloads (prompts, outputs) stay on the
host in an id-keyed table; only the IDs ride the rings.

The class implements the master surface
:class:`~repro_torch.serve.engine.ServeCluster` drives (``replicas`` /
``submit`` / ``agree`` / ``rebalance_many`` / ``telemetry`` / ``stats``), so
``ServeCluster(execution="vmap" | "mesh")`` is a drop-in switch.

On a mesh every rank builds the master and makes the same calls in the
same order (the SPMD contract of :mod:`repro_torch.distributed.executor`):
a replica's wave is popped by its lane's owner and broadcast from there,
so every rank resolves the same requests.  ``metrics()`` polls the
admission surface and the backing runtime into one Prometheus registry.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.ops import to_numpy
from repro_torch.core.policy import StealPolicy
from repro_torch.distributed.launch import launch_runtime
from repro_torch.runtime.adaptive import AdaptiveConfig
from repro_torch.runtime.resilience import FaultPlan

__all__ = ["RuntimeAdmissionMaster", "DeviceReplicaLane"]

_SPEC = torch.zeros((), dtype=torch.int32)


class DeviceReplicaLane:
    """One replica's view of its executor lane: the ``ReplicaQueue``
    surface (``load`` / ``pop_wave`` / ``finish_wave``) over ring slot
    ``replica_id`` of the master's runtime."""

    def __init__(self, master: "RuntimeAdmissionMaster", replica_id: int):
        self._master = master
        self.replica_id = replica_id
        self.in_flight = 0
        self.completed = 0
        self.evicted = False

    def __len__(self) -> int:
        return int(self._master.runtime.sizes()[self.replica_id])

    def load(self) -> int:
        return len(self) + self.in_flight

    def pop_wave(self, max_wave: int) -> List:
        """Pop up to ``max_wave`` newest request IDs off this lane — ONE
        owner-side bulk pop (K3), not per-item dispatches — and resolve
        them to :class:`~repro_torch.serve.scheduler.Request` objects,
        newest first (the host queues' LIFO discipline)."""
        rt = self._master.runtime
        i = self.replica_id
        if rt.lanes.owns(i):
            batch, n = rt.pop_bulk(i, int(max_wave), int(max_wave))
        else:  # a same-shaped stand-in for the owner's broadcast
            batch = torch.zeros((int(max_wave),), dtype=torch.int32,
                                device=rt.device)
            n = torch.zeros((), dtype=torch.int32, device=rt.device)
        got = rt.lanes.broadcast_tree({"batch": batch, "n": n}, i)
        # pop_bulk returns the block oldest-first; reverse for LIFO.
        rids = to_numpy(got["batch"])[: int(got["n"])][::-1]
        wave = [self._master.lookup(int(r)) for r in rids]
        self.in_flight += len(wave)
        return wave

    def finish_wave(self, n: int) -> None:
        self.in_flight -= n
        self.completed += n

    # ``AdmissionMaster.rebalance`` reads ``r.q``; the cluster only ever
    # touches len()/load(), which this object answers itself.
    @property
    def q(self):
        return self


class RuntimeAdmissionMaster:
    """The single stealer + admission router, on executor lanes.

    Args:
      n_replicas: lanes (= ranks of the mesh under ``execution="mesh"``).
      policy / adaptive / adaptive_config: as the host master; the
        policy's proportion seeds the runtime's adaptive controller.
      execution: ``"vmap"`` or ``"mesh"`` (see
        :func:`repro_torch.distributed.launch_runtime`).
      capacity: per-lane ring capacity (queued request IDs per replica).
      mesh: optional pinned mesh for ``execution="mesh"``.
      item_spec: per-item ring payload.  The default (a scalar int32) is
        the id-keyed wave mode described above; the decode engine
        (:mod:`repro_torch.serve.decode`) passes its request-item spec so
        admitted prompts ride the rings and the superstep can steal them
        — when overriding, admit through ``runtime.push`` with batches of
        that spec rather than :meth:`submit`.  (The JAX package's
        ``max_pop`` has no counterpart: the port's bulk pops size
        themselves from each call's ``max_n``.)
      elastic: arm the runtime's fault layer (an empty
        :class:`~repro_torch.runtime.resilience.FaultPlan`) so
        :meth:`evict` / :meth:`readmit` can drain and mask lanes live —
        the default, in both execution modes.
      backend / device: the runtime's queue backend and device, as
        :func:`~repro_torch.distributed.launch_runtime` takes them
        (``device=None``: CUDA, or each rank's CUDA device on a mesh).
    """

    def __init__(self, n_replicas: int,
                 policy: Optional[StealPolicy] = None,
                 adaptive: bool = True,
                 adaptive_config: Optional[AdaptiveConfig] = None, *,
                 execution: str = "vmap",
                 capacity: int = 512,
                 mesh=None,
                 item_spec=None,
                 elastic: bool = True,
                 backend=None,
                 device=None):
        self.policy = policy or StealPolicy(proportion=0.5,
                                            low_watermark=1,
                                            high_watermark=8,
                                            max_steal=min(256, capacity))
        self.execution = execution
        self.item_spec = _SPEC if item_spec is None else item_spec
        self.runtime = launch_runtime(
            n_replicas, capacity, self.item_spec, execution=execution,
            mesh=mesh, policy=self.policy, adaptive=adaptive,
            adaptive_config=adaptive_config, backend=backend,
            fault_plan=FaultPlan() if elastic else None, device=device)
        self.replicas = [DeviceReplicaLane(self, i)
                         for i in range(n_replicas)]
        self._requests: Dict[int, object] = {}
        self.stolen = 0
        # Automatic failure detection (attach_detector): None = off.  Fed
        # wall-clock wave observations by the cluster, separate from any
        # runtime-level detector.
        self.detector = None

    # -- request table -------------------------------------------------------

    def lookup(self, rid: int):
        return self._requests[rid]

    # -- the AdmissionMaster surface ----------------------------------------

    @property
    def telemetry(self):
        """The runtime's round + wave stream (the cluster appends
        ``WaveRecord``s here, next to the executor's ``RoundRecord``s)."""
        return self.runtime.telemetry

    @property
    def controller(self):
        return self.runtime.controller

    @property
    def rounds(self) -> int:
        return self.runtime.rounds_run

    @property
    def proportion(self) -> float:
        return self.runtime.proportion

    def _loads(self) -> List[int]:
        """Every replica's queued + in-flight requests (one size read)."""
        sizes = self.runtime.sizes()
        return [int(sizes[r.replica_id]) + r.in_flight
                for r in self.replicas]

    def agree(self, flag: bool) -> bool:
        """``flag`` of any lane: every rank of a mesh must take the same
        straggler and eviction decisions, which a wall clock of its own
        would not give it (one lane max; the flag itself on stacked
        lanes)."""
        lanes = self.runtime.lanes
        if lanes.stacked:
            return bool(flag)
        x = torch.full((1,), int(bool(flag)), dtype=torch.int32,
                       device=self.runtime.device)
        return bool(int(lanes.max(x)[0]))

    def submit(self, requests: Sequence) -> int:
        """Bulk-admit to the least-loaded live replica: ONE ring splice
        of the request-id batch (K2, constant latency in the batch
        size)."""
        requests = list(requests)
        if not requests:
            return -1
        loads = self._loads()
        live = [r for r in self.replicas if not r.evicted]
        if not live:
            raise RuntimeError("every replica is evicted; nothing can admit")
        target = min(live, key=lambda r: loads[r.replica_id])
        for r in requests:
            self._requests[r.rid] = r
        rids = torch.tensor([r.rid for r in requests], dtype=torch.int32)
        pushed = self.runtime.push(target.replica_id, rids, len(requests))
        lanes = self.runtime.lanes
        if not lanes.stacked:  # the owner's count, on every rank
            mine = torch.tensor([pushed], dtype=torch.int32,
                                device=self.runtime.device)
            pushed = int(lanes.all_gather(mine)[target.replica_id])
        if pushed < len(requests):
            raise RuntimeError(
                f"admission ring overflow on replica {target.replica_id}: "
                f"pushed {pushed}/{len(requests)} (capacity "
                f"{self.runtime.capacity})")
        return target.replica_id

    # -- planned eviction ----------------------------------------------------

    def evict(self, replica_id: int) -> int:
        """Planned eviction on device: kill the lane in the runtime's
        fault schedule, then run recovery rounds until its ring is empty
        — each round is the ordinary exchange superstep executing the
        proportion-1.0 dead-worker plan.  Returns the number of queued
        requests drained off the lane.  Requires ``elastic=True``."""
        from repro_torch.distributed.elastic import evacuate

        lane = self.replicas[replica_id]
        drained = int(len(lane))
        evacuate(self.runtime, [replica_id])
        lane.evicted = True
        self.telemetry.record_fault("evict")
        return drained

    def readmit(self, replica_id: int) -> None:
        """Re-admit an evicted lane: revive it in the fault schedule so
        the next plans may route work back into it; its straggler penalty
        and the master's detector state for it clear."""
        self.runtime.revive_lane(replica_id)
        if self.detector is not None:
            self.detector.revive(replica_id)
        self.replicas[replica_id].evicted = False
        self.telemetry.record_fault("readmit")

    def note_straggler(self, rounds: int = 4, factor: float = 1.5,
                       lane: Optional[int] = None) -> None:
        """A replica was flagged slow: delegates to the runtime (counter
        + temporary steal-proportion boost, attributed to ``lane``)."""
        self.runtime.note_straggler(rounds=rounds, factor=factor, lane=lane)

    def attach_detector(self, policy=None):
        """Arm the shared :class:`repro_torch.runtime.detector.
        FailureDetector` escalation policy: SUSPECTED -> straggler boost,
        DEAD -> a real on-device :meth:`evict` (recorded as
        ``auto_evict``).  The owner feeds observations; :meth:`readmit`
        revives.  Returns the detector."""
        from repro_torch.runtime.detector import (DetectorPolicy,
                                                  FailureDetector)

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

    def rebalance(self) -> int:
        """One REAL rebalance round through the executor (plan + exchange
        + adaptive update + telemetry).  Returns requests moved."""
        before = self.runtime.telemetry.total_transferred
        self.runtime.round()
        moved = self.runtime.telemetry.total_transferred - before
        self.stolen += moved
        return moved

    def rebalance_many(self, k: int) -> int:
        """Up to ``k`` rounds per tick, stopping once a round moves
        nothing (the host master's early-exit discipline)."""
        moved = 0
        for _ in range(int(k)):
            step = self.rebalance()
            moved += step
            if step == 0:
                break
        return moved

    def stats(self) -> Dict:
        sizes = self.runtime.sizes()
        return {
            "loads": [int(sizes[r.replica_id]) + r.in_flight
                      for r in self.replicas],
            "queued": [int(sizes[r.replica_id]) for r in self.replicas],
            "completed": [r.completed for r in self.replicas],
            "evicted": [r.replica_id for r in self.replicas if r.evicted],
            "stolen": self.stolen,
            "rounds": self.rounds,
            "proportion": self.proportion,
            "execution": self.execution,
            "backend": self.runtime.ops.resolved,
            "telemetry": self.telemetry.summary(),
        }

    def metrics(self, registry=None):
        """Poll this master into a :class:`repro_torch.obs.metrics.
        MetricsRegistry`: the admission surface (per-replica loads,
        steal totals, detector census) PLUS the backing runtime's lane
        metrics — one registry covers both layers of the device
        master."""
        from repro_torch.obs.metrics import collect_runtime, master_metrics

        reg = master_metrics(self, registry)
        return collect_runtime(reg, self.runtime)
