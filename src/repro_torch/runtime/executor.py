"""The unified executor: adaptive rebalancing rounds over queue lanes
(PyTorch port of ``repro.runtime.executor``).

A *round* is::

    [worker body: pop_bulk -> compute -> push]   (optional)
    master.superstep / hierarchical_superstep    (bulk steal rebalance)

Lane contract.  The JAX package writes ONE lane's view of a round and maps
it with ``jax.vmap(axis_name=...)`` or ``shard_map``, so worker bodies and
the master use named-axis collectives.  Here a runtime holds the lanes of
its process and their collectives (:attr:`StealRuntime.lanes`,
:mod:`repro_torch.core.lanes`):

* a worker body is ``body(qs, carry) -> (qs, carry)`` on the held lanes'
  :class:`~repro_torch.core.ops.QueueState` (cursors ``(n,)``, rings
  ``(n, cap, ...)``) and a carry whose leaves lead with ``(n,)``, where
  ``n`` is ``lanes.n_local``: all W on stacked lanes, 1 on a mesh rank
  (:class:`repro_torch.distributed.MeshStealRuntime`);
* a lane-axis ``all_gather`` is ``lanes.all_gather`` (on stacked lanes
  the stacked tensor itself);
* ``lax.pmax`` over the lanes is ``lanes.max`` (on stacked lanes
  ``max(dim=0)`` broadcast back to W);
* ``psum(1)`` over the lanes is ``lanes.n``, i.e. W.

Properties of the hot path:

* **One queue contract** — the runtime resolves one
  :class:`~repro_torch.core.ops.BulkOps` backend at construction
  (:attr:`StealRuntime.ops`); worker bodies use the same object, so on the
  ``"cuda"`` routing every ring move is one launch of K1-K4 for all lanes.
* **In place** — the runtime owns its rings: the superstep splices with
  ``donate=True`` and worker bodies may do the same, so no round copies a
  full-capacity ring.
* **No host sync inside a round** — cursors, counts, the plan and the
  float32 proportion stay on the device (on a mesh this holds under
  ``nccl``; ``gloo`` stages every collective through the host).
  :meth:`StealRuntime.round` reads back once at its end;
  :meth:`StealRuntime.run_fused` runs k rounds and reads back once per
  block.  ``until_drained=True`` keeps a
  device-side "still active" flag (every lane empty before a round ends
  the block, as the JAX package's ``lax.while_loop`` condition does) and
  a round counter: rounds past the drain run under
  :meth:`BulkOps.gated` with the flag False, so they move nothing, and
  the carry and the proportion are kept by ``torch.where``; the host
  trims the block to the rounds that ran.

Resilience (:mod:`repro_torch.runtime.resilience`): built with a
:class:`~repro_torch.runtime.resilience.FaultPlan`, every round also runs
the dead-ring recovery superstep, dead and delayed lanes' worker bodies
are discarded, and ``kill_lane`` / ``revive_lane`` / ``note_straggler``
and an attached failure detector give the host live control; the
schedule of a block is uploaded once before it.  ``pod_size`` groups the
lanes into pods (:func:`~repro_torch.core.master.hierarchical_superstep`).
Snapshots (``save_state`` / ``restore_state`` / ``attach_snapshots``)
ride :mod:`repro_torch.train.checkpoint` with the JAX package's keys and
layout, so a snapshot of either package restores into the other, and a
snapshot of a mesh (written by lane 0, all W lanes gathered) into the
stacked runtime and back.

With the sanitizer on (``REPRO_CHECK=1``, or a backend made with
``check=True``), every op of a round is checked lane by lane
(:mod:`repro_torch.analysis.sanitize`) and its violations are recorded;
after the block's read-back the runtime checks each round's size vector,
and for rounds with no worker body the multiset of live items across all
lanes, then raises :class:`~repro_torch.analysis.sanitize.SanitizerError`
on anything recorded.  These checks read back per op.

Observability (:mod:`repro_torch.obs`): :meth:`StealRuntime.metrics`
polls the runtime into a Prometheus registry, and
:meth:`StealRuntime.attach_phase_probe` splits every round's time into
``worker_body`` / ``exchange`` / ``splice`` / ``adaptive_update``.  The
JAX package times truncated prefix programs of a round and estimates
fused rounds from calibrated fractions; here the round is issued from
Python, so a :class:`~repro_torch.obs.phase.PhaseClock` marks each
boundary as it is issued (CUDA events on the device, ``perf_counter`` on
the CPU) and the block's times are read once, after its read-back, for
every round, fused or not.  The probe adds no host sync, no launch and
no change to any result.  The host spans of :func:`repro_torch.obs.phase.
span`, when on, name what the host is issuing: ``repro.block`` (a
:meth:`StealRuntime.run_fused` call), ``repro.round`` (each round, and
:meth:`StealRuntime.round`), ``repro.worker_body``, the superstep's
(:mod:`repro_torch.core.master`), ``repro.adaptive_update``, and after
the rounds ``repro.read_back`` and ``repro.bookkeeping``.

CUDA graphs (:mod:`repro_torch.runtime.block_graph`): a block whose
worker body carries ``_graph_key`` runs, on stacked lanes on a CUDA
device with no fault layer, no sanitizer and no armed phase probe, as the
replay of one graph of its k rounds, captured once per geometry in the
process (host spans ``repro.capture`` and ``repro.replay``); its
read-back and bookkeeping are the eager block's.  Every other block is
issued op by op as above.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import (resolve_device, tree_leaves,
                               tree_leaves_with_path, tree_map)
from repro_torch.core import master as master_ops
from repro_torch.core import ops as bulk_ops
from repro_torch.core.lanes import StackedLanes, stack_stats
from repro_torch.core.policy import StealPolicy
from repro_torch.core.sharded_queue import make_sharded_queues
from repro_torch.obs.phase import span, trace_span
from repro_torch.runtime import block_graph, resilience
from repro_torch.runtime.adaptive import (AdaptiveConfig, AdaptiveController,
                                          adaptive_update)
from repro_torch.runtime.resilience import FaultPlan, FaultState
from repro_torch.runtime.telemetry import Telemetry, reduce_round_stats

Pytree = Any
WorkerFn = Callable[[bulk_ops.QueueState, Pytree],
                    Tuple[bulk_ops.QueueState, Pytree]]

__all__ = ["StealRuntime", "make_lane_step"]


def _pack(*tensors: torch.Tensor) -> torch.Tensor:
    """int32 / float32 device tensors as one int32 vector (float32 as its
    bits), for one transfer."""
    return torch.cat([
        (t.view(torch.int32) if t.dtype == torch.float32
         else t.to(torch.int32)).reshape(-1) for t in tensors])


def _unpack(host: np.ndarray, like) -> List[np.ndarray]:
    """The host copy of :func:`_pack`'s vector split back into arrays
    shaped and typed like the tensors ``like``."""
    out, at = [], 0
    for t in like:
        part = host[at:at + t.numel()].reshape(tuple(t.shape))
        out.append(part.view(np.float32) if t.dtype == torch.float32
                   else part)
        at += t.numel()
    return out


def _read_back(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Host copies of int32 / float32 device tensors in ONE transfer
    (float32 travels as its bits)."""
    return _unpack(_pack(*tensors).cpu().numpy(), tensors)


def _assign(dst: Pytree, src: Pytree) -> None:
    """Copy ``src``'s leaves into ``dst``'s, skipping a leaf that is
    already its destination."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not s:
            d.copy_(s)


def _layout(tree: Pytree) -> Optional[tuple]:
    """The shapes and dtypes of ``tree``'s leaves by path, or None when a
    leaf is not a tensor."""
    leaves = tree_leaves_with_path(tree)
    if not all(isinstance(x, torch.Tensor) for _, x in leaves):
        return None
    return tuple((path, tuple(x.shape), x.dtype) for path, x in leaves)


def make_lane_step(policy: StealPolicy, ops: bulk_ops.BulkOps,
                   worker_fn: Optional[WorkerFn], *,
                   pod_size: Optional[int] = None, lanes=None,
                   fault: bool = False) -> Callable:
    """The one definition of a round:
    ``(q, carry, proportion, faults=None, mark=None) -> (q, carry, stats)``
    on the lanes ``lanes`` holds (default: the stack of ``q``).

    A round is the optional worker body, then the rebalancing superstep at
    the float32 tensor ``proportion`` (flat, or two-level in pods of
    ``pod_size``), splicing into the rings of ``q`` in place.
    :class:`StealRuntime` runs it on stacked lanes and
    :class:`repro_torch.distributed.MeshStealRuntime` with one lane per
    rank (``lanes`` a :class:`~repro_torch.core.lanes.MeshLanes`), so both
    run the same computation.  With ``fault=True`` the round is
    :func:`~repro_torch.runtime.resilience.make_resilient_lane`'s, which
    needs the round's :class:`~repro_torch.runtime.resilience.RoundFaults`
    as ``faults`` (ignored otherwise).

    The JAX package's ``stage=`` compiles truncated prefixes of the round
    for its phase probe.  Here ``mark`` takes its place: the phase clock's
    boundary hook (:meth:`repro_torch.obs.phase.PhaseClock.mark`), called
    with ``"worker_body"`` after the worker body and ``"exchange"`` after
    the superstep's exchange, on the committed round itself."""
    if fault:
        return resilience.make_resilient_lane(policy, ops, worker_fn,
                                              pod_size=pod_size, lanes=lanes)

    def lane(q, carry, proportion, faults=None, mark=None):
        del faults  # the fault layer is off
        if worker_fn is not None:
            with span("worker_body"):
                q, carry = worker_fn(q, carry)
        if mark is not None:
            mark("worker_body")
        pol = dataclasses.replace(policy, proportion=proportion)
        if pod_size is not None:
            q, stats = master_ops.hierarchical_superstep(
                q, pol, pod_size=pod_size, ops=ops, donate=True, lanes=lanes,
                mark=mark)
        else:
            q, stats = master_ops.superstep(q, pol, ops=ops, donate=True,
                                            lanes=lanes, mark=mark)
        return q, carry, stats

    return lane


class StealRuntime:
    """Owns per-worker queues — all W stacked on one device, or this
    process's one lane of a mesh — and drives adaptive rebalancing
    rounds.

    Args:
      n_workers: number of queue lanes.
      capacity: ring capacity per lane.
      item_spec: payload pytree of tensors describing ONE item.
      policy: base :class:`StealPolicy`; its ``proportion`` seeds the
        adaptive controller, the rest is static.
      adaptive: enable the steal-proportion feedback loop (default on).
      backend: optional :class:`~repro_torch.core.ops.BulkOps` backend
        override (a registry name or an instance); by default
        ``policy.backend``.  ``"auto"`` is the kernel routing unless
        ``REPRO_QUEUE_BACKEND`` names another backend.  The ring's
        geometry (``capacity``, ``policy.max_steal``) reaches the
        backend's factory, so ``"relaxed"`` gets its optimistic steal
        where the window fits.
      device: where the lanes live; ``None`` means CUDA and raises without
        it.
      pod_size: if set, lanes are grouped into pods of this size and each
        round runs :func:`~repro_torch.core.master.hierarchical_superstep`
        (within each pod, then across the pods' lane-0 representatives).
      fault_plan: arm the resilience layer with a deterministic
        :class:`~repro_torch.runtime.resilience.FaultPlan`.  An EMPTY
        ``FaultPlan()`` schedules nothing but still arms the machinery —
        live :meth:`kill_lane` / :meth:`revive_lane` and the per-round
        recovery superstep.  ``None`` (default) runs the unarmed round.
        Composes with ``pod_size``: a dead lane drains within its pod, an
        entirely dead pod across pods.
      lanes: the lane collectives (:mod:`repro_torch.core.lanes`); by
        default all ``n_workers`` lanes stacked on ``device``.
        :class:`~repro_torch.distributed.MeshStealRuntime` passes its
        mesh's.

    On a mesh every rank makes the same calls in the same order (the
    SPMD contract of :mod:`repro_torch.distributed.executor`); the
    host-side results (``sizes``, stats, telemetry, ``drain``) are the
    stacked runtime's on every rank.

    """

    def __init__(self, n_workers: int, capacity: int, item_spec: Pytree, *,
                 policy: Optional[StealPolicy] = None,
                 adaptive: bool = True,
                 adaptive_config: Optional[AdaptiveConfig] = None,
                 backend: str | bulk_ops.BulkOps | None = None,
                 device=None,
                 pod_size: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 lanes=None):
        if pod_size is not None and n_workers % pod_size != 0:
            raise ValueError(
                f"n_workers={n_workers} not divisible by pod_size={pod_size}")
        self.device = resolve_device(device)
        self.n_workers = int(n_workers)
        self.lanes = lanes or StackedLanes(self.n_workers)
        if self.lanes.n != self.n_workers:
            raise ValueError(f"lanes span {self.lanes.n} workers, not "
                             f"{self.n_workers}")
        self.capacity = int(capacity)
        self.item_spec = item_spec
        self.pod_size = pod_size
        base = policy or StealPolicy()
        if backend is None:
            backend = base.backend  # honour a pinned policy.backend
        self.ops = bulk_ops.make_ops(backend, capacity=self.capacity,
                                     max_steal=base.max_steal)
        # The sanitizer's round checkpoints are armed exactly when
        # make_ops wrapped the backend (REPRO_CHECK=1 or check=True).
        self._check = self.ops.checked
        self.policy = dataclasses.replace(base, backend=self.ops.name)
        self.queues = make_sharded_queues(self.lanes.n_local, capacity,
                                          item_spec, device=self.device)
        self.controller = (AdaptiveController(self.policy, adaptive_config)
                           if adaptive else None)
        self.telemetry = Telemetry(item_bytes=bulk_ops.item_nbytes(item_spec),
                                   capacity=capacity)
        self.rounds_run = 0
        # Resilience: the host-side fault schedule (None = machinery off).
        if fault_plan is not None:
            # The dead-lane sentinel (low_watermark + 1) must be neither
            # idle-eligible nor a victim, or masked plans would route
            # work into corpses.
            lo = self.policy.low_watermark + 1
            hi = max(self.policy.high_watermark, self.policy.queue_limit)
            if not (self.policy.low_watermark < lo < hi):
                raise ValueError(
                    f"fault injection needs low_watermark + 1 ="
                    f" {lo} strictly between low_watermark and"
                    f" max(high_watermark, queue_limit) = {hi}")
            self.fault: Optional[FaultState] = FaultState(fault_plan,
                                                          self.n_workers)
            if fault_plan.kills:
                self.telemetry.record_fault("planned_kill",
                                            len(fault_plan.kills))
        else:
            self.fault = None
        self.detector = None  # attach_detector
        self._snapshot_dir: Optional[str] = None
        self._snapshot_every = 0
        self._snapshot_keep = 3
        self._last_snapshot_round = -1
        self._phase_probe = None  # attach_phase_probe
        self._clock = None
        # run_fused blocks captured, replayed and run eager
        self.graph_blocks = {"captures": 0, "replays": 0, "eager": 0}
        # graphs run() holds from their first replay to its end, by key
        self._held: Dict[Any, Any] = {}
        self._holding = False

    # -- state access --------------------------------------------------------

    @property
    def proportion(self) -> float:
        """The steal proportion the NEXT round will use (including any
        temporary straggler boost the controller is applying)."""
        return (self.controller.effective_proportion if self.controller
                else self.policy.proportion)

    def sizes(self) -> np.ndarray:
        """``(W,)``: every lane's queue size, in lane order."""
        return self.lanes.all_gather(self.queues.size).cpu().numpy()

    def total_size(self) -> int:
        return int(self.sizes().sum())

    def gathered_queues(self) -> bulk_ops.QueueState:
        """All W lanes' queue state stacked in lane order — the queues
        themselves on stacked lanes, a gather on a mesh."""
        return self.lanes.all_gather_tree(self.queues)

    # -- host-side seeding / draining ---------------------------------------

    def _lane(self, worker: int) -> bulk_ops.QueueState:
        """Lane ``worker`` (held here) as a single queue whose rings are
        VIEWS of the stack, so in-place ops write the stacked rings."""
        q, row = self.queues, worker - self.lanes.offset
        return bulk_ops.QueueState(tree_map(lambda b: b[row], q.buf),
                                   q.lo[row], q.size[row])

    def _set_lane(self, worker: int, lane: bulk_ops.QueueState) -> None:
        q, row = self.queues, worker - self.lanes.offset
        lo, size = q.lo.clone(), q.size.clone()
        lo[row], size[row] = lane.lo, lane.size
        self.queues = bulk_ops.QueueState(q.buf, lo, size)

    def push(self, worker: int, batch: Pytree, n: int) -> int:
        """Owner-side bulk push into one lane (host-level seeding); returns
        the items pushed here — on a mesh only the lane's owner pushes,
        and the other ranks do nothing and return 0."""
        if not self.lanes.owns(worker):
            return 0
        batch = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                         batch)
        lane, pushed = self.ops.push(self._lane(worker), batch, n,
                                     donate=True)
        self._set_lane(worker, lane)
        return int(pushed)

    def _owned(self, worker: int) -> None:
        if not self.lanes.owns(worker):
            raise ValueError(f"lane {worker} is not held by this rank")

    def pop_bulk(self, worker: int, max_n: int, n) -> Tuple[Pytree,
                                                           torch.Tensor]:
        """Owner-side bulk pop of up to ``n`` newest items off one lane
        (K3); returns ``(batch, n_popped)``, the block oldest first and
        its rows >= ``n_popped`` zeroed.  Only the lane's owner calls it."""
        self._owned(worker)
        lane, batch, got = self.ops.pop_bulk(self._lane(worker), max_n, n)
        self._set_lane(worker, lane)
        return batch, got

    def steal_exact(self, worker: int, n, max_steal: int) -> Tuple[
            Pytree, torch.Tensor]:
        """Owner-side steal of the ``n`` oldest items (clamped to the
        lane's size and ``max_steal``) off one lane (K1); returns
        ``(batch, n_stolen)``.  Only the lane's owner calls it."""
        self._owned(worker)
        lane, batch, got = self.ops.steal_exact(self._lane(worker), n,
                                                max_steal=max_steal)
        self._set_lane(worker, lane)
        return batch, got

    def drain(self) -> list:
        """Pop every lane dry (host-level; for tests / inspection).
        Returns per-lane item lists (numpy leaves), newest first, for all
        W lanes on every rank."""
        out = []
        for i in range(self.lanes.offset,
                       self.lanes.offset + self.lanes.n_local):
            lane, items = self._lane(i), []
            while int(lane.size) > 0:
                lane, item, valid = self.ops.pop(lane)
                assert bool(valid)
                items.append(tree_map(bulk_ops.to_numpy, item))
            self._set_lane(i, lane)
            out.append(items)
        return self.lanes.gather_objects(out)

    # -- resilience: live faults, stragglers ---------------------------------

    def _require_fault(self) -> FaultState:
        if self.fault is None:
            raise RuntimeError(
                "fault layer not armed — construct the runtime with "
                "fault_plan=FaultPlan() to enable kill/revive")
        return self.fault

    def kill_lane(self, lane: int, at_round: Optional[int] = None) -> None:
        """Declare lane ``lane`` dead from round ``at_round`` (default: the
        next round).  Its worker body stops producing, it leaves every
        plan, and the recovery superstep drains its ring into the
        survivors at proportion 1.0 over the following rounds.  Killing an
        already-dead lane raises (the schedule is the replay contract)."""
        fault = self._require_fault()
        at = self.rounds_run if at_round is None else at_round
        if bool(fault.dead_at(max(at, self.rounds_run))[lane]):
            raise ValueError(
                f"lane {lane} is already dead (kill_round="
                f"{int(fault.kill_round[lane])}); revive_lane first")
        fault.kill(lane, at)
        self.telemetry.record_fault("kill", lane=lane)

    def revive_lane(self, lane: int) -> None:
        """Re-admit a killed lane: it rejoins plans from the next round
        with whatever its (drained) ring holds, and its straggler penalty
        is cleared."""
        self._require_fault().revive(lane)
        if self.controller is not None:
            self.controller.clear_straggler(lane)
        if self.detector is not None:
            self.detector.revive(lane)
        self.telemetry.record_fault("revive", lane=lane)

    def dead_lanes(self) -> np.ndarray:
        """(W,) bool: lanes dead as of the next round to run."""
        if self.fault is None:
            return np.zeros((self.n_workers,), bool)
        return self.fault.dead_at(self.rounds_run)

    def note_straggler(self, rounds: int = 4, factor: float = 1.5,
                       lane: Optional[int] = None) -> None:
        """Record a detected straggler: counts into telemetry and boosts
        the adaptive steal proportion for ``rounds`` rounds; ``lane``
        attributes the boost so :meth:`revive_lane` can clear it."""
        self.telemetry.record_fault("straggler", lane=lane)
        if self.controller is not None:
            self.controller.flag_straggler(rounds=rounds, factor=factor,
                                           lane=lane)

    def attach_detector(self, policy=None):
        """Arm the failure detector (:mod:`repro_torch.runtime.detector`):
        per-lane delay streaks replayed from the fault schedule escalate
        suspected -> dead — a suspected lane gets a :meth:`note_straggler`
        boost, a lane past ``dead_after`` slow rounds a real
        :meth:`kill_lane`.  With ``DetectorPolicy.wall_clock`` each
        block's measured wall time per round also feeds every live lane's
        wall baseline (suspicion only, unless ``wall_kill``).  Requires
        the fault layer.  Returns the detector (also at :attr:`detector`).
        """
        from repro_torch.runtime.detector import (DetectorPolicy,
                                                  FailureDetector)

        self._require_fault()
        pol = policy or DetectorPolicy()

        def on_suspect(lane: int) -> None:
            self.telemetry.record_fault("suspect", lane=lane)
            self.note_straggler(rounds=pol.boost_rounds,
                                factor=pol.boost_factor, lane=lane)

        def on_dead(lane: int) -> None:
            if not bool(self.dead_lanes()[lane]):
                self.kill_lane(lane)
                self.telemetry.record_fault("auto_kill", lane=lane)

        def on_revive(lane: int) -> None:
            if self.controller is not None:
                self.controller.clear_straggler(lane)

        self.detector = FailureDetector(self.n_workers, pol,
                                        on_suspect=on_suspect,
                                        on_dead=on_dead,
                                        on_revive=on_revive)
        return self.detector

    def _feed_detector(self, round0: int, n_rounds: int,
                       wall_s: Optional[float] = None) -> None:
        """One observation per (round, live lane) from the replayed delay
        schedule — deterministic, so the same schedule converts to the
        same kills at the same rounds as in the JAX package — plus, with
        ``wall_clock``, the block's wall time per round."""
        if self.detector is None or self.fault is None:
            return
        f = self.fault
        for r in range(round0, round0 + n_rounds):
            dead, slow = f.dead_at(r), f.delayed_at(r)
            for w in range(self.n_workers):
                if not dead[w]:  # corpses emit no heartbeats
                    self.detector.observe(w, bool(slow[w]))
        if (wall_s is not None and n_rounds > 0
                and self.detector.policy.wall_clock):
            dead = f.dead_at(round0 + n_rounds)
            for w in range(self.n_workers):
                if not dead[w]:
                    self.detector.observe_wall(w, wall_s / n_rounds)

    def _controller_sizes(self, sizes: np.ndarray) -> np.ndarray:
        """The sizes the host controller servos on: dead lanes masked to
        the sentinel, as the fused loop masks them on the device."""
        if self.fault is None:
            return sizes
        dead = self.fault.dead_at(self.rounds_run + 1)
        return np.where(dead, np.int32(self.policy.low_watermark + 1),
                        np.asarray(sizes, np.int32))

    # -- resilience: snapshot / restore --------------------------------------

    def state_dict(self, *, gather: bool = True) -> Dict[str, Any]:
        """The checkpointable state: the W lanes' stacked queues, the servo
        proportion (un-boosted), the global round counter and, when
        armed, the fault schedule — the JAX package's keys.  Taken only at
        round boundaries, where no item is mid-exchange.  On a mesh the
        queues are gathered (a collective); ``gather=False`` gives
        shape-only placeholders of them instead."""
        p = (self.controller.proportion if self.controller is not None
             else self.policy.proportion)
        if gather or self.lanes.stacked:
            queues = self.gathered_queues()
        else:
            queues = tree_map(lambda x: torch.empty(
                (self.n_workers,) + tuple(x.shape[1:]), dtype=x.dtype,
                device="meta"), self.queues)
        out: Dict[str, Any] = {
            "queues": queues,
            "proportion": torch.tensor(p, dtype=torch.float32),
            "rounds_run": torch.tensor(self.rounds_run, dtype=torch.int32),
        }
        if self.fault is not None:
            out["fault"] = {k: torch.from_numpy(v.copy())
                            for k, v in self.fault.state_dict().items()}
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore from the W lanes' state: this process keeps its own
        lanes' rows."""
        self.queues = tree_map(
            lambda x: self.lanes.local(torch.as_tensor(x)).to(
                self.device).contiguous(),
            state["queues"])
        p = float(state["proportion"])
        if self.controller is not None:
            self.controller.proportion = p
            self.controller.history.append(p)
        self.rounds_run = int(state["rounds_run"])
        if self.fault is not None and "fault" in state:
            self.fault.load_state({
                k: bulk_ops.to_numpy(torch.as_tensor(v))
                for k, v in state["fault"].items()})

    def save_state(self, ckpt_dir: str, *, keep: int = 3) -> int:
        """Atomic snapshot at the current round boundary
        (:mod:`repro_torch.train.checkpoint`: tmp dir + rename, keep-k).
        On a mesh every rank calls it, lane 0 writes, and every rank
        returns once the snapshot is on disk.  Returns the step (=
        ``rounds_run``) it was saved under."""
        from repro_torch.train import checkpoint

        extra = {"n_workers": self.n_workers, "capacity": self.capacity,
                 "fault_events": dict(self.telemetry.fault_events),
                 "straggler_steps": self.telemetry.straggler_steps}
        state = self.state_dict()
        if self.lanes.writer:
            checkpoint.save(ckpt_dir, self.rounds_run, state, extra=extra,
                            keep=keep)
        self.lanes.barrier()
        return self.rounds_run

    def restore_state(self, ckpt_dir: str, *, step: Optional[int] = None
                      ) -> int:
        """Restore queues, proportion, round counter (and fault schedule)
        from the latest (or given) snapshot, onto this runtime's device —
        a snapshot of a flat runtime restores into a hierarchical one.
        Returns the restored round index."""
        from repro_torch.train import checkpoint

        state, _step, extra = checkpoint.restore(
            ckpt_dir, self.state_dict(gather=False), step=step,
            device=self.device)
        self.load_state_dict(state)
        for kind, n in (extra.get("fault_events") or {}).items():
            self.telemetry.fault_events.setdefault(kind, 0)
            self.telemetry.fault_events[kind] = max(
                self.telemetry.fault_events[kind], int(n))
        self.telemetry.straggler_steps = max(
            self.telemetry.straggler_steps,
            int(extra.get("straggler_steps", 0)))
        self.telemetry.record_fault("restore")
        self._last_snapshot_round = self.rounds_run
        return self.rounds_run

    def attach_snapshots(self, ckpt_dir: str, *, every: int = 8,
                         keep: int = 3) -> None:
        """Snapshot the queue state every ``every`` rounds (checked after
        each :meth:`round` / :meth:`run_fused`, at a round boundary)."""
        self._snapshot_dir = ckpt_dir
        self._snapshot_every = max(int(every), 1)
        self._snapshot_keep = keep
        self._last_snapshot_round = self.rounds_run

    def _maybe_snapshot(self) -> None:
        if self._snapshot_dir is None:
            return
        if self.rounds_run - self._last_snapshot_round >= self._snapshot_every:
            self.save_state(self._snapshot_dir, keep=self._snapshot_keep)
            self._last_snapshot_round = self.rounds_run

    # -- the round -----------------------------------------------------------

    def _step(self, worker_fn: Optional[WorkerFn], qs, carry,
              proportion: torch.Tensor, faults=None, mark=None):
        """One round on this runtime's lanes: :func:`make_lane_step` at the
        current policy, backend, pods and fault layer."""
        step = make_lane_step(self.policy, self.ops, worker_fn,
                              pod_size=self.pod_size, lanes=self.lanes,
                              fault=self.fault is not None)
        return step(qs, carry, proportion, faults, mark=mark)

    def _ctx(self, k: int):
        """The fault schedule of the next ``k`` rounds on the device (one
        upload), or None when the fault layer is off."""
        if self.fault is None:
            return None
        return self.fault.ctx(self.rounds_run, k, device=self.device,
                              rows=(self.lanes.offset, self.lanes.n_local))

    def _default_carry(self, carry):
        if carry is None:
            return torch.zeros((self.lanes.n_local,), dtype=torch.int32,
                               device=self.device)
        return carry

    def _p(self) -> torch.Tensor:
        return torch.full((), self.proportion, dtype=torch.float32,
                          device=self.device)

    # -- observability -------------------------------------------------------

    def attach_phase_probe(self, probe=None, **kwargs):
        """Arm per-round phase attribution (:mod:`repro_torch.obs.phase`):
        every later :meth:`round` and :meth:`run_fused` round gets the
        ``t_worker`` / ``t_exchange`` / ``t_splice`` / ``t_adaptive``
        fields of its :class:`~repro_torch.runtime.telemetry.
        RoundRecord`, measured at the phase boundaries
        (``Telemetry.phase_summary()`` aggregates them).  Pass an existing
        :class:`~repro_torch.obs.phase.PhaseProbe` or its constructor
        kwargs (``enabled=``, ``calibrate_every=``).  Returns the probe
        (also at ``_phase_probe``); ``probe.enabled = False`` disarms it,
        and the runtime then makes no mark and creates no event."""
        from repro_torch.obs.phase import PhaseClock, PhaseProbe

        if probe is None:
            probe = PhaseProbe(**kwargs)
        self._phase_probe = probe
        self._clock = PhaseClock(self.device)
        return probe

    def _phase_clock(self):
        """The phase clock, started, when an enabled probe is attached;
        None otherwise."""
        if self._phase_probe is None or not self._phase_probe.enabled:
            return None
        self._clock.start()
        return self._clock

    def _phase_records(self, clock, wall_s: float, rounds: int,
                       t_adaptive: Optional[float] = None) -> List:
        """The probe's ``phases=`` records of a block's first ``rounds``
        rounds, read from ``clock`` after the block's read-back; the
        rounds partition ``wall_s`` (plus ``t_adaptive``, the host
        controller's time after the wall, for a :meth:`round`): the last
        one's splice takes what the marks do not cover."""
        if clock is None or rounds == 0:
            return [None] * rounds
        probe, out, spent = self._phase_probe, [], 0.0
        for r, ph in enumerate(clock.rounds()[:rounds]):
            w, x = ph["worker_body"], ph["exchange"]
            if t_adaptive is None:  # on the device, inside the wall
                a, rest = ph["adaptive_update"], ph["adaptive_update"]
            else:
                a, rest = t_adaptive, 0.0
            full = (wall_s - spent - rest if r == rounds - 1
                    else w + x + ph["splice"])
            sample = probe.direct_sample(t_worker=w, t_exchange=w + x,
                                         t_full=full, t_adaptive=a)
            spent += sample.total
            out.append(sample.as_record())
        return out

    def metrics(self, registry=None):
        """Poll this runtime into a :class:`repro_torch.obs.metrics.
        MetricsRegistry` (queue depths, steal totals, fault/detector
        census, phase attribution when probed).  Pull-style and
        side-effect free — call it mid-run at any cadence;
        ``registry.to_prometheus()`` / ``.snapshot()`` render it."""
        from repro_torch.obs.metrics import runtime_metrics

        return runtime_metrics(self, registry)

    # -- the round (continued) -----------------------------------------------

    def round(self, worker_fn: Optional[WorkerFn] = None,
              carry: Optional[Pytree] = None
              ) -> Tuple[Pytree, master_ops.RebalanceStats]:
        """Run one round; feeds telemetry and the adaptive controller.

        ``carry`` is a pytree with a leading axis of the lanes held here
        (``lanes.n_local``) handed to ``worker_fn`` (a zero placeholder
        when omitted).  Returns ``(carry_out, stats)`` with device-tensor
        stats in the stacked layout.  One host read at the end.
        """
        with span("round"):
            carry = self._default_carry(carry)
            proportion = self.proportion
            snap = self._pre_dispatch_snapshot(worker_fn)
            ctx = self._ctx(1)
            t0 = time.perf_counter()
            clock = self._phase_clock()
            with self._deferred():
                self.queues, carry, stats = self._step(
                    worker_fn, self.queues, carry, self._p(),
                    None if ctx is None else ctx.round(0),
                    mark=None if clock is None else clock.mark)
            if clock is not None:
                clock.mark("splice")
            [stats] = stack_stats(self.lanes, [stats], pod_size=self.pod_size)
            host = master_ops.RebalanceStats(*_read_back(*stats))
            wall_s = time.perf_counter() - t0
            if self._check:
                self._post_dispatch_checks([host], snap,
                                           context="StealRuntime.round")
            t_a0 = time.perf_counter()
            if self.controller is not None:
                self.controller.update(
                    self._controller_sizes(host.sizes_after))
            [phases] = self._phase_records(
                clock, wall_s, 1, t_adaptive=time.perf_counter() - t_a0)
            self._record(host, proportion, phases)
            r0 = self.rounds_run
            self.rounds_run += 1
            self._feed_detector(r0, 1, wall_s=wall_s)
            self._maybe_snapshot()
            return carry, stats

    def _deferred(self):
        """With the sanitizer on, the block's op violations are recorded
        and raised at its read-back; otherwise nothing."""
        if not self._check:
            return contextlib.nullcontext()
        from repro_torch.analysis import sanitize

        return sanitize.deferred()

    def _pre_dispatch_snapshot(self, worker_fn):
        """With the sanitizer on and no worker body (a pure rebalance),
        fingerprint the live items for the post-block conservation
        check."""
        if not self._check or worker_fn is not None:
            return None
        from repro_torch.analysis import sanitize

        return sanitize.queues_fingerprint(self.gathered_queues())

    def _post_dispatch_checks(self, round_stats, snap, *, context) -> None:
        """The sanitizer's checkpoint after a block's read-back: each
        round's sizes, the multiset for pure rebalances, then whatever
        the ops recorded."""
        from repro_torch.analysis import sanitize

        for stats_r in round_stats:
            sanitize.check_round_stats(stats_r, n_workers=self.n_workers,
                                       capacity=self.capacity,
                                       context=context)
        if snap is not None:
            sanitize.check_conserved(
                snap, sanitize.queues_fingerprint(self.gathered_queues()),
                context=context)
        sanitize.raise_pending(context)

    def _record(self, host_stats, proportion: float, phases=None) -> None:
        """One RoundRecord from a round's host-side stats (and the phase
        probe's record, when probed)."""
        n_steals, n_transferred, bytes_moved = reduce_round_stats(
            host_stats, n_workers=self.n_workers, pod_size=self.pod_size)
        self.telemetry.record(sizes=host_stats.sizes_after, n_steals=n_steals,
                              n_transferred=n_transferred,
                              proportion=proportion, bytes_moved=bytes_moved,
                              phases=phases)

    def run_fused(self, k: int, worker_fn: Optional[WorkerFn] = None,
                  carry: Optional[Pytree] = None, *,
                  until_drained: bool = False):
        """Run up to ``k`` rounds with ONE host read-back.

        The proportion is updated on the device after every round
        (:func:`~repro_torch.runtime.adaptive.adaptive_update`, the same
        float32 computation the host controller runs, on sizes with dead
        lanes masked) and per-round telemetry is read back once at the
        end.  Under a fault plan the block's schedule is uploaded once
        before it.

        With ``until_drained=False`` (default) exactly ``k`` rounds run and
        ``(carry_out, stats)`` is returned, ``stats`` leaves leading with
        ``(k,)``.  With ``until_drained=True`` the block stops doing work
        once every lane is empty before a round (see the module
        docstring) and returns ``(carry_out, stats, rounds)``, ``rounds <=
        k`` the rounds executed and ``stats`` leaves leading with
        ``(rounds,)``.

        A worker body that carries ``_graph_key`` may run as the replay
        of one CUDA graph of the block (:mod:`repro_torch.runtime.
        block_graph`, host spans ``repro.capture`` and ``repro.replay``),
        with the same results, copied off the graph's static tensors;
        inside :meth:`run`, which holds the graph to its end, they stay
        there until then.  :attr:`graph_blocks` counts the blocks
        captured, replayed and run eager.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        with span("block"):
            carry = self._default_carry(carry)
            key = self._graph_key(worker_fn, carry, k, until_drained)
            entry = self._held.get(key) or block_graph.acquire(key)
            snap = self._pre_dispatch_snapshot(worker_fn)
            t0 = time.perf_counter()
            clock = self._phase_clock()
            with trace_span(f"run_fused_k{k}"):
                if entry is None:
                    self.graph_blocks["eager"] += 1
                    with self._deferred():
                        self.queues, carry, per_round, ran, p = \
                            self._fused_rounds(
                                k, worker_fn, self.queues, carry, self._p(),
                                until_drained,
                                mark=None if clock is None else clock.mark)
                    with span("read_back"):
                        stacked, props = self._stack_block(per_round)
                        # ONE host read-back for the whole block.
                        host_ran, p_final, props, *host = _read_back(
                            ran, p, props, *stacked)
                else:
                    try:
                        carry, stacked, flat, like = self._replay_block(
                            entry, k, worker_fn, carry, until_drained)
                        with span("read_back"):
                            host_ran, p_final, props, *host = _unpack(
                                flat.cpu().numpy(), like)
                    finally:
                        if self._holding:
                            self._held[key] = entry
                        else:
                            entry.release()
            wall_s = time.perf_counter() - t0
            with span("bookkeeping"):
                rounds = int(host_ran) if until_drained else k
                host_rounds = [
                    master_ops.RebalanceStats(*(x[r] for x in host))
                    for r in range(rounds)]
                if self._check:
                    self._post_dispatch_checks(
                        host_rounds, snap,
                        context=f"StealRuntime.run_fused[{rounds} rounds]")
                phases = self._phase_records(clock, wall_s, rounds)
                for r, host_r in enumerate(host_rounds):
                    self._record(host_r, float(props[r]), phases[r])
                if self.controller is not None and rounds > 0:
                    self.controller.absorb(props[:rounds], float(p_final))
                r0 = self.rounds_run
                self.rounds_run += rounds
                self._feed_detector(r0, rounds, wall_s=wall_s)
                self._maybe_snapshot()
                if until_drained:
                    stacked = master_ops.RebalanceStats(
                        *(x[:rounds] for x in stacked))
                    return carry, stacked, rounds
                return carry, stacked

    def _stack_block(self, per_round):
        """A block's per-round ``(stats, proportion)`` as one
        :class:`~repro_torch.core.master.RebalanceStats` of ``(k, ...)``
        leaves and the ``(k,)`` proportions, on the device."""
        stacked = master_ops.RebalanceStats(*map(torch.stack, zip(
            *stack_stats(self.lanes, [stats for stats, _ in per_round],
                         pod_size=self.pod_size))))
        return stacked, torch.stack([q for _, q in per_round])

    def _graph_key(self, worker_fn, carry, k: int, until_drained: bool):
        """The key of this block's captured graph
        (:mod:`repro_torch.runtime.block_graph`): the worker body's
        ``_graph_key`` and this runtime's geometry; None where the block
        runs eager (no key, lanes not stacked on a CUDA device, the fault
        layer, the sanitizer, an armed phase probe)."""
        body = getattr(worker_fn, "_graph_key", None)
        if (body is None or self.fault is not None or self._check
                or not isinstance(self.lanes, StackedLanes)
                or not block_graph.supported(self.device)
                or (self._phase_probe is not None
                    and self._phase_probe.enabled)):
            return None
        layout = _layout(carry)
        if layout is None:
            return None
        config = self.controller.config if self.controller else None
        return (body, self.device, self.n_workers, self.capacity,
                _layout(self.item_spec), self.policy, config, self.pod_size,
                type(self.ops), self.ops.name, layout, k, until_drained)

    def _replay_block(self, entry, k: int, worker_fn, carry,
                      until_drained: bool):
        """The block as the replay of ``entry``'s graph, captured here on
        its first use: the values the eager block reads at its start (the
        queues, ``carry``, the proportion) written into the graph's static
        inputs (a leaf already there is not copied), then one replay,
        whose queues, carry and stats are copied off the static tensors,
        which the entry's next holder overwrites, unless :meth:`run`
        holds the entry.  Returns ``(carry, stats, read-back vector, its
        layout)``, the last two static tensors of the graph, read while
        ``entry`` is held."""
        if not entry.captured:
            with span("capture"):
                entry.queues = tree_map(torch.clone, self.queues)
                entry.carry = tree_map(torch.clone, carry)
                entry.p = self._p()

                def block():
                    qs, out, per_round, ran, p = self._fused_rounds(
                        k, worker_fn, entry.queues, entry.carry, entry.p,
                        until_drained)
                    stacked, props = self._stack_block(per_round)
                    like = (ran, p, props, *stacked)
                    flat = _pack(*like)
                    # the block's outputs become its inputs: replays run
                    # in place
                    _assign(entry.queues, qs)
                    _assign(entry.carry, out)
                    _assign(entry.p, p)
                    return stacked, flat, like

                entry.capture(block, self.device)
            self.graph_blocks["captures"] += 1
        else:
            _assign(entry.queues, self.queues)
            _assign(entry.carry, carry)
            entry.p.fill_(self.proportion)
        with span("replay"):
            stacked, flat, like = entry.replay()
            if self._holding:
                self.queues = entry.queues
                carry = tree_map(lambda x: x, entry.carry)
            else:
                self.queues, carry, stacked = tree_map(
                    torch.clone, (entry.queues, entry.carry, stacked))
        self.graph_blocks["replays"] += 1
        return carry, stacked, flat, like

    def _fused_rounds(self, k: int, worker_fn, qs, carry, p: torch.Tensor,
                      until_drained: bool, mark=None):
        """The k rounds of :meth:`run_fused` from the queues ``qs``, the
        carry and the 0-d proportion ``p``, on the device, no read-back:
        ``(queues, carry, [(stats, proportion)] per round, rounds run,
        final proportion)``.  ``mark``: the phase clock's boundary hook
        (the splice ends once the round's carry is kept, the adaptive
        update once the next proportion is), or None."""
        config = self.controller.config if self.controller else None
        ctx = self._ctx(k)
        active = torch.ones((), dtype=torch.bool, device=self.device)
        ran = torch.zeros((), dtype=torch.int32, device=self.device)
        per_round = []
        # every lane's size before the next round (the drain signal and
        # the adaptive update's input), gathered once a round
        sizes = self.lanes.all_gather(qs.size) if until_drained else None
        for i in range(k):
            with span("round"):
                faults = None if ctx is None else ctx.round(i)
                if until_drained:
                    active = active & (sizes.sum() > 0)
                    with self.ops.gated(active):
                        qs, new_carry, stats = self._step(
                            worker_fn, qs, carry, p, faults, mark)
                    carry = tree_map(
                        lambda new, old: torch.where(active, new, old),
                        new_carry, carry)
                    ran = ran + active.to(torch.int32)
                else:
                    qs, carry, stats = self._step(worker_fn, qs, carry, p,
                                                  faults, mark)
                if mark is not None:
                    mark("splice")
                per_round.append((stats, p))
                with span("adaptive_update"):
                    if self.controller is not None or until_drained:
                        sizes = self.lanes.all_gather(qs.size)
                    if self.controller is not None:
                        masked = resilience.mask_sizes(
                            sizes, None if ctx is None else ctx.dead[i + 1],
                            self.policy)
                        p_new = adaptive_update(p, masked, policy=self.policy,
                                                config=config)
                        p = torch.where(active, p_new, p)
                if mark is not None:
                    mark("adaptive_update")
        return qs, carry, per_round, ran, p

    def run(self, worker_fn: Optional[WorkerFn] = None,
            carry: Optional[Pytree] = None, *,
            max_rounds: int = 10_000,
            stop_when_empty: bool = True,
            fused: int = 1) -> Pytree:
        """Drive rounds until the queues drain (or ``max_rounds``).

        With ``fused > 1`` the loop advances up to ``fused`` rounds per
        :meth:`run_fused` block; when ``stop_when_empty`` the block stops
        doing work the moment every lane drains.  A block's CUDA graph,
        once replayed, is held to the end of the run, so later blocks copy
        nothing in or out of it; the end copies the results off it and
        lets it go.
        """
        self._holding = fused > 1
        try:
            return self._run(worker_fn, carry, max_rounds, stop_when_empty,
                             fused)
        finally:
            self._holding = False
            held, self._held = self._held, {}
            for entry in held.values():
                entry.release()

    def _run(self, worker_fn, carry, max_rounds: int, stop_when_empty: bool,
             fused: int) -> Pytree:
        rounds = 0
        while rounds < max_rounds:
            if fused > 1:
                k = min(fused, max_rounds - rounds)
                if stop_when_empty:
                    carry, _, executed = self.run_fused(
                        k, worker_fn, carry, until_drained=True)
                    rounds += max(executed, 1)
                    if executed < k:
                        break
                else:
                    carry, _ = self.run_fused(k, worker_fn, carry)
                    rounds += k
            else:
                carry, _ = self.round(worker_fn, carry)
                rounds += 1
                if stop_when_empty and self.total_size() == 0:
                    break
        if self._held:
            # the last block's results, off the graphs' static tensors
            self.queues, carry = tree_map(torch.clone, (self.queues, carry))
        return carry
