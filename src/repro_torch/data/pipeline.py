"""Host-side data pipeline on the paper's queue: per-host shard queues
with bulk refill and straggler bulk-steal (PyTorch port of
``repro.data.pipeline``; pure host code).

Concurrency model is EXACTLY the paper's: each host queue has one owner
(the host's feeder) and at most one stealer (the pipeline master).  The
queue is any ``core.host_queue.HostQueue`` implementation (default: the
faithful paper port, LinkedWSQueue): bulk push of prefetched batches,
single pop by the training step, and the master's proportional steal(p)
when a host falls behind.

A "task" here is a (shard, step) descriptor — regenerating any batch is
deterministic (data.synthetic), so stolen descriptors are recomputed by
the thief host with zero data movement (locality: only 8 bytes/task
travel, the paper's cheap-bulk-transfer property taken to its limit).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.host_queue import HostQueue, LinkedWSQueue
from repro_torch.core.policy import StealPolicy, adaptive_chunk
from repro_torch.train.fault import StragglerMonitor

__all__ = ["HostShardQueue", "PipelineMaster", "WorkStealingPipeline"]

Task = Tuple[int, int]  # (shard, step)


class HostShardQueue:
    """Owner side: prefetch task descriptors in bulk; pop per train step."""

    def __init__(self, shard: int, prefetch: int = 64,
                 queue_factory: Callable[[], HostQueue] = LinkedWSQueue):
        self.shard = shard
        self.q: HostQueue = queue_factory()
        self.prefetch = prefetch
        self._next_step = 0
        self.monitor = StragglerMonitor()

    def refill(self) -> int:
        """Bulk push the next `prefetch` task descriptors (one splice)."""
        tasks = [(self.shard, self._next_step + i)
                 for i in range(self.prefetch)]
        self._next_step += self.prefetch
        # push_bulk's deque convention (later = newer): the owner pops
        # the newest step first while the oldest steps sit at the steal
        # side for the master.
        self.q.push_bulk(tasks)
        return len(tasks)

    def pop(self) -> Optional[Task]:
        if len(self.q) == 0:
            self.refill()
        return self.q.pop_item()


class PipelineMaster:
    """The single stealer: watches per-host consumption, bulk-steals task
    descriptors from stragglers, and re-assigns them to fast hosts."""

    def __init__(self, queues: List[HostShardQueue],
                 policy: Optional[StealPolicy] = None):
        self.queues = queues
        self.policy = policy or StealPolicy(proportion=0.5)
        self.stolen_total = 0
        self.rounds = 0

    def rebalance(self, slow: List[int], fast: List[int]) -> int:
        """One master round: steal from each slow host, splice into fast
        hosts round-robin.  Returns tasks moved."""
        self.rounds += 1
        moved = 0
        if not slow or not fast:
            return 0
        p = adaptive_chunk(len(fast), len(slow), self.policy.proportion)
        grabbed: List[Task] = []
        for s in slow:
            stolen = self.queues[s].q.steal_bulk(p)
            grabbed.extend(stolen)
            moved += len(stolen)
        for i, task in enumerate(grabbed):
            tq = self.queues[fast[i % len(fast)]]
            tq.q.push_bulk([task])
        self.stolen_total += moved
        return moved


class WorkStealingPipeline:
    """Drives H host queues + master; ``next_batch(host)`` is what a
    training loop calls.  Generation happens on the popping host via the
    deterministic ``make_batch`` (no payload movement on steal)."""

    def __init__(self, n_hosts: int, make_batch: Callable[[int, int], Dict],
                 prefetch: int = 64, policy: Optional[StealPolicy] = None):
        self.queues = [HostShardQueue(h, prefetch) for h in range(n_hosts)]
        self.master = PipelineMaster(self.queues, policy)
        self.make_batch = make_batch
        self._lock = threading.Lock()

    def next_batch(self, host: int) -> Dict:
        self.queues[host].monitor.start()
        task = self.queues[host].pop()
        if task is None:  # stolen dry: refill own shard
            self.queues[host].refill()
            task = self.queues[host].pop()
        batch = self.make_batch(*task)
        straggler = self.queues[host].monitor.observe()
        if straggler:
            with self._lock:
                fast = [h for h in range(len(self.queues)) if h != host]
                self.master.rebalance([host], fast)
        return batch

    def stats(self) -> Dict:
        return {
            "stolen_total": self.master.stolen_total,
            "rounds": self.master.rounds,
            "sizes": [len(q.q) for q in self.queues],
            "straggler_steps": [q.monitor.straggler_steps
                                for q in self.queues],
        }
