"""The unified executor: adaptive rebalancing rounds over stacked queue
lanes on one GPU (PyTorch port of ``repro.runtime.executor``).

A *round* is::

    [worker body: pop_bulk -> compute -> push]   (optional)
    master.superstep                             (bulk steal rebalance)

Lane contract.  The JAX package writes ONE lane's view of a round and maps
it with ``jax.vmap(axis_name=...)``, so worker bodies and the master use
named-axis collectives.  Here the W lanes are stacked tensors and every
function sees all of them at once:

* a worker body is ``body(qs, carry) -> (qs, carry)`` on the stacked
  :class:`~repro_torch.core.ops.QueueState` (cursors ``(W,)``, rings
  ``(W, cap, ...)``) and a carry whose leaves lead with ``(W,)``;
* a lane-axis ``all_gather`` is the stacked tensor itself;
* ``lax.pmax`` over the lanes is ``max(dim=0)`` (broadcast back to W);
* ``psum(1)`` over the lanes is ``W``.

Properties of the hot path:

* **One queue contract** — the runtime resolves one
  :class:`~repro_torch.core.ops.BulkOps` backend at construction
  (:attr:`StealRuntime.ops`); worker bodies use the same object, so on the
  ``"cuda"`` routing every ring move is one launch of K1-K4 for all lanes.
* **In place** — the runtime owns its rings: the superstep splices with
  ``donate=True`` and worker bodies may do the same, so no round copies a
  full-capacity ring.
* **No host sync inside a round** — cursors, counts, the plan and the
  float32 proportion stay on the device.  :meth:`StealRuntime.round`
  reads back once at its end; :meth:`StealRuntime.run_fused` runs k
  rounds and reads back once per block.  ``until_drained=True`` keeps a
  device-side "still active" flag (every lane empty before a round ends
  the block, as the JAX package's ``lax.while_loop`` condition does) and
  a round counter: rounds past the drain run under
  :meth:`BulkOps.gated` with the flag False, so they move nothing, and
  the carry and the proportion are kept by ``torch.where``; the host
  trims the block to the rounds that ran.

With the sanitizer on (``REPRO_CHECK=1``, or a backend made with
``check=True``), every op of a round is checked lane by lane
(:mod:`repro_torch.analysis.sanitize`) and its violations are recorded;
after the block's read-back the runtime checks each round's size vector,
and for rounds with no worker body the multiset of live items across all
lanes, then raises :class:`~repro_torch.analysis.sanitize.SanitizerError`
on anything recorded.  These checks read back per op.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.core import master as master_ops
from repro_torch.core import ops as bulk_ops
from repro_torch.core.policy import StealPolicy
from repro_torch.core.sharded_queue import make_sharded_queues
from repro_torch.runtime.adaptive import (AdaptiveConfig, AdaptiveController,
                                          adaptive_update)
from repro_torch.runtime.telemetry import Telemetry, reduce_round_stats

Pytree = Any
WorkerFn = Callable[[bulk_ops.QueueState, Pytree],
                    Tuple[bulk_ops.QueueState, Pytree]]

__all__ = ["StealRuntime"]


def _read_back(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Host copies of int32 / float32 device tensors in ONE transfer
    (float32 travels as its bits)."""
    flat = torch.cat([
        (t.view(torch.int32) if t.dtype == torch.float32
         else t.to(torch.int32)).reshape(-1) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        part = host[at:at + t.numel()].reshape(tuple(t.shape))
        out.append(part.view(np.float32) if t.dtype == torch.float32
                   else part)
        at += t.numel()
    return out


class StealRuntime:
    """Owns W stacked per-worker queues on one device and drives adaptive
    rebalancing rounds.

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

    Faults, the phase probe, snapshots, the failure detector and
    hierarchical pods of the JAX runtime are not ported yet.
    """

    def __init__(self, n_workers: int, capacity: int, item_spec: Pytree, *,
                 policy: Optional[StealPolicy] = None,
                 adaptive: bool = True,
                 adaptive_config: Optional[AdaptiveConfig] = None,
                 backend: str | bulk_ops.BulkOps | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.n_workers = int(n_workers)
        self.capacity = int(capacity)
        self.item_spec = item_spec
        base = policy or StealPolicy()
        if backend is None:
            backend = base.backend  # honour a pinned policy.backend
        self.ops = bulk_ops.make_ops(backend, capacity=self.capacity,
                                     max_steal=base.max_steal)
        # The sanitizer's round checkpoints are armed exactly when
        # make_ops wrapped the backend (REPRO_CHECK=1 or check=True).
        self._check = self.ops.checked
        self.policy = dataclasses.replace(base, backend=self.ops.name)
        self.queues = make_sharded_queues(n_workers, capacity, item_spec,
                                          device=self.device)
        self.controller = (AdaptiveController(self.policy, adaptive_config)
                           if adaptive else None)
        self.telemetry = Telemetry(item_bytes=bulk_ops.item_nbytes(item_spec),
                                   capacity=capacity)
        self.rounds_run = 0

    # -- state access --------------------------------------------------------

    @property
    def proportion(self) -> float:
        """The steal proportion the NEXT round will use."""
        return (self.controller.proportion if self.controller
                else self.policy.proportion)

    def sizes(self) -> np.ndarray:
        return self.queues.size.cpu().numpy()

    def total_size(self) -> int:
        return int(self.sizes().sum())

    # -- host-side seeding / draining ---------------------------------------

    def _lane(self, worker: int) -> bulk_ops.QueueState:
        """Lane ``worker`` as a single queue whose rings are VIEWS of the
        stack, so in-place ops write the stacked rings."""
        q = self.queues
        return bulk_ops.QueueState(tree_map(lambda b: b[worker], q.buf),
                                   q.lo[worker], q.size[worker])

    def _set_lane(self, worker: int, lane: bulk_ops.QueueState) -> None:
        q = self.queues
        lo, size = q.lo.clone(), q.size.clone()
        lo[worker], size[worker] = lane.lo, lane.size
        self.queues = bulk_ops.QueueState(q.buf, lo, size)

    def push(self, worker: int, batch: Pytree, n: int) -> int:
        """Owner-side bulk push into one lane (host-level seeding)."""
        batch = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                         batch)
        lane, pushed = self.ops.push(self._lane(worker), batch, n,
                                     donate=True)
        self._set_lane(worker, lane)
        return int(pushed)

    def drain(self) -> list:
        """Pop every lane dry (host-level; for tests / inspection).
        Returns per-lane item lists (numpy leaves), newest first."""
        out = []
        for i in range(self.n_workers):
            lane, items = self._lane(i), []
            while int(lane.size) > 0:
                lane, item, valid = self.ops.pop(lane)
                assert bool(valid)
                items.append(tree_map(bulk_ops.to_numpy, item))
            self._set_lane(i, lane)
            out.append(items)
        return out

    # -- the round -----------------------------------------------------------

    def _step(self, worker_fn: Optional[WorkerFn], qs, carry,
              proportion: torch.Tensor):
        """One round on the stacked lanes, on the device: worker body, then
        the superstep at the float32 ``proportion``, splicing in place."""
        if worker_fn is not None:
            qs, carry = worker_fn(qs, carry)
        pol = dataclasses.replace(self.policy, proportion=proportion)
        qs, stats = master_ops.superstep(qs, pol, ops=self.ops, donate=True)
        return qs, carry, stats

    def _default_carry(self, carry):
        if carry is None:
            return torch.zeros((self.n_workers,), dtype=torch.int32,
                               device=self.device)
        return carry

    def _p(self) -> torch.Tensor:
        return torch.full((), self.proportion, dtype=torch.float32,
                          device=self.device)

    def round(self, worker_fn: Optional[WorkerFn] = None,
              carry: Optional[Pytree] = None
              ) -> Tuple[Pytree, master_ops.RebalanceStats]:
        """Run one round; feeds telemetry and the adaptive controller.

        ``carry`` is a pytree with a leading ``(n_workers,)`` axis handed
        to ``worker_fn`` (a zero placeholder when omitted).  Returns
        ``(carry_out, stats)`` with device-tensor stats.  One host read
        at the end.
        """
        carry = self._default_carry(carry)
        proportion = self.proportion
        snap = self._pre_dispatch_snapshot(worker_fn)
        with self._deferred():
            self.queues, carry, stats = self._step(worker_fn, self.queues,
                                                   carry, self._p())
        host = master_ops.RebalanceStats(*_read_back(*stats))
        if self._check:
            self._post_dispatch_checks([host], snap,
                                       context="StealRuntime.round")
        self._record(host, proportion)
        if self.controller is not None:
            self.controller.update(host.sizes_after)
        self.rounds_run += 1
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

        return sanitize.queues_fingerprint(self.queues)

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
                snap, sanitize.queues_fingerprint(self.queues),
                context=context)
        sanitize.raise_pending(context)

    def _record(self, host_stats, proportion: float) -> None:
        """One RoundRecord from a round's host-side stats."""
        n_steals, n_transferred, bytes_moved = reduce_round_stats(host_stats)
        self.telemetry.record(sizes=host_stats.sizes_after, n_steals=n_steals,
                              n_transferred=n_transferred,
                              proportion=proportion, bytes_moved=bytes_moved)

    def run_fused(self, k: int, worker_fn: Optional[WorkerFn] = None,
                  carry: Optional[Pytree] = None, *,
                  until_drained: bool = False):
        """Run up to ``k`` rounds with ONE host read-back.

        The proportion is updated on the device after every round
        (:func:`~repro_torch.runtime.adaptive.adaptive_update`, the same
        float32 computation the host controller runs) and per-round
        telemetry is read back once at the end.

        With ``until_drained=False`` (default) exactly ``k`` rounds run and
        ``(carry_out, stats)`` is returned, ``stats`` leaves leading with
        ``(k,)``.  With ``until_drained=True`` the block stops doing work
        once every lane is empty before a round (see the module
        docstring) and returns ``(carry_out, stats, rounds)``, ``rounds <=
        k`` the rounds executed and ``stats`` leaves leading with
        ``(rounds,)``.
        """
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        carry = self._default_carry(carry)
        snap = self._pre_dispatch_snapshot(worker_fn)
        with self._deferred():
            carry, per_round, ran, p = self._fused_rounds(
                k, worker_fn, carry, until_drained)

        stacked = master_ops.RebalanceStats(*map(torch.stack, zip(
            *(stats for stats, _ in per_round))))
        props = torch.stack([q for _, q in per_round])
        host_ran, p_final, props, *host = _read_back(ran, p, props, *stacked)
        rounds = int(host_ran) if until_drained else k
        host_rounds = [master_ops.RebalanceStats(*(x[r] for x in host))
                       for r in range(rounds)]
        if self._check:
            self._post_dispatch_checks(
                host_rounds, snap,
                context=f"StealRuntime.run_fused[{rounds} rounds]")
        for r, host_r in enumerate(host_rounds):
            self._record(host_r, float(props[r]))
        if self.controller is not None and rounds > 0:
            self.controller.absorb(props[:rounds], float(p_final))
        self.rounds_run += rounds
        if until_drained:
            stacked = master_ops.RebalanceStats(*(x[:rounds] for x in stacked))
            return carry, stacked, rounds
        return carry, stacked

    def _fused_rounds(self, k: int, worker_fn, carry, until_drained: bool):
        """The k rounds of :meth:`run_fused` on the device, no read-back:
        ``(carry, [(stats, proportion)] per round, rounds run, final
        proportion)``."""
        qs, p = self.queues, self._p()
        config = self.controller.config if self.controller else None
        active = torch.ones((), dtype=torch.bool, device=self.device)
        ran = torch.zeros((), dtype=torch.int32, device=self.device)
        per_round = []
        for _ in range(k):
            if until_drained:
                active = active & (qs.size.sum() > 0)
                with self.ops.gated(active):
                    qs, new_carry, stats = self._step(worker_fn, qs, carry, p)
                carry = tree_map(lambda new, old: torch.where(active, new, old),
                                 new_carry, carry)
                ran = ran + active.to(torch.int32)
            else:
                qs, carry, stats = self._step(worker_fn, qs, carry, p)
            per_round.append((stats, p))
            if self.controller is not None:
                p_new = adaptive_update(p, qs.size, policy=self.policy,
                                        config=config)
                p = torch.where(active, p_new, p)
        self.queues = qs
        return carry, per_round, ran, p

    def run(self, worker_fn: Optional[WorkerFn] = None,
            carry: Optional[Pytree] = None, *,
            max_rounds: int = 10_000,
            stop_when_empty: bool = True,
            fused: int = 1) -> Pytree:
        """Drive rounds until the queues drain (or ``max_rounds``).

        With ``fused > 1`` the loop advances up to ``fused`` rounds per
        :meth:`run_fused` block; when ``stop_when_empty`` the block stops
        doing work the moment every lane drains.
        """
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
        return carry
