"""Faithful host-level port of the paper's lock-free work-stealing queue
(restated from ``repro.core.host_queue``, which uses no framework; the
tests hold the two equal operation for operation).

This module transcribes Listings 1-4 of the paper into Python as closely as
the language allows.  Its queues run on the host: the serving admission
master (``repro_torch.serve.scheduler``) keeps one per replica, and the
baselines below reproduce the cost structure of the Taskflow-style deques
the paper compares against.

Fidelity notes:

* C++ ``std::atomic`` memory orders have no Python analogue.  CPython's GIL
  makes single attribute loads/stores atomic, which is *stronger* than the
  relaxed/acquire/release orders the paper needs, so the algorithm's logic
  transcribes 1:1 while the fence-level reasoning is vacuous here.  The
  *structure* — single cut linearization point, size re-check abort, second
  traversal for the non-optimized count — is preserved exactly.
* ``LinkedWSQueue.steal`` implements Listing 4 including the
  ``_queue_limit_`` abort and the drain consistency check
  (``ssz <= sz - (k >> 1)``); ``steal_optimized`` implements the paper's
  §IV optimization: skip the tail traversal when the owner made no
  concurrent update (detected by the size being unchanged), returning
  immediately after the cut.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, List, Optional, Protocol, Tuple, runtime_checkable

__all__ = [
    "LFNode",
    "llist_from_iter",
    "HostQueue",
    "LinkedWSQueue",
    "PerItemDequeQueue",
    "ResizingArrayQueue",
]

QUEUE_LIMIT = 2  # the paper's ``_queue_limit_``


@runtime_checkable
class HostQueue(Protocol):
    """The uniform host-level queue contract — the host analogue of
    :class:`repro_torch.core.ops.BulkOps`.

    Every host implementation (the faithful :class:`LinkedWSQueue` port
    and the Taskflow-style :class:`PerItemDequeQueue` /
    :class:`ResizingArrayQueue` baselines) satisfies it, so the serving
    master swaps implementations through ONE surface.

    The protocol deliberately uses plain-python payload lists — the
    native representations (pre-linked ``llist`` batches) stay available
    on each class.
    """

    def push_bulk(self, items: Iterable[Any]) -> None:
        """Owner side: enqueue a batch of items (one bulk operation).
        Deque convention across ALL implementations: later items are
        newer — ``pop_item`` returns the batch's last item first, the
        stealer reaches its first items last-retained."""
        ...

    def pop_item(self) -> Optional[Any]:
        """Owner side: pop the newest item, or None when empty."""
        ...

    def steal_bulk(self, proportion: float) -> List[Any]:
        """Stealer side: detach ~``proportion`` of the queue from the
        steal side; returns the stolen payloads.  Intra-block order is
        implementation-defined.  Every implementation here takes
        exactly the oldest items."""
        ...

    def make_batch(self, items: Iterable[Any]) -> Any:
        """Producer-side batch preparation (pre-linking, device transfer).
        Separated from :meth:`push_batch` so the benchmark harness times
        only the splice — the paper's Fig. 6 measures exactly that."""
        ...

    def push_batch(self, prepared: Any) -> None:
        """Owner side: splice a batch prepared by :meth:`make_batch`."""
        ...

    def __len__(self) -> int:
        ...


class LFNode:
    """``lf_node``: payload + next pointer.  (Cache-line padding from
    Listing 1 is meaningless in CPython and omitted.)"""

    __slots__ = ("next", "payload")

    def __init__(self, payload: Any = None):
        self.next: Optional["LFNode"] = None
        self.payload = payload


def llist_from_iter(items) -> Tuple[Optional[LFNode], Optional[LFNode], int]:
    """Build an ``llist`` (start, end, n) from an iterable — the pre-linked
    batch format the owner hands to ``push``."""
    start = end = None
    n = 0
    for it in items:
        node = LFNode(it)
        if start is None:
            start = end = node
        else:
            node.next = None
            end.next = node
            end = node
        n += 1
    return start, end, n


class LinkedWSQueue:
    """The paper's queue: singly linked list + ``size`` + ``head``.

    Owner API: :meth:`push`, :meth:`pop`.
    Stealer API: :meth:`steal`, :meth:`steal_optimized` (single concurrent
    stealer, enforced by the caller as in the paper's master-worker model).
    """

    def __init__(self, queue_limit: int = QUEUE_LIMIT):
        self.head: Optional[LFNode] = None
        self.size: int = 0
        self.queue_limit = queue_limit

    # -- owner ----------------------------------------------------------------

    def push(self, llist: Tuple[Optional[LFNode], Optional[LFNode], int]) -> None:
        """Listing 2: splice the pre-linked batch at the head.  O(1) in the
        batch size — the source of the paper's flat Fig. 6 latency."""
        start, end, n = llist
        if start is None:
            return
        end.next = self.head          # end->next = head.load(RELAXED)
        self.head = start             # head.store(start, RELEASE)
        self.size += n                # size.fetch_add(n, ACQ_REL)

    def pop(self) -> Optional[Any]:
        """Listing 3."""
        rv = self.head                # head.load(RELAXED)
        if rv is None:
            return None
        self.head = rv.next           # head.store(rv->next, RELAXED)
        self.size -= 1                # size.fetch_sub(1, ACQ_REL)
        rv.next = None
        return rv.payload

    # -- stealer --------------------------------------------------------------

    def steal(self, proportion: float):
        """Listing 4, non-optimized: traverse to the cut point, consistency
        check, sever, then traverse the stolen suffix to count it."""
        proportion = 1.0 - proportion
        sz = self.size                      # size.load(ACQUIRE)
        if sz < self.queue_limit:
            return (None, None, 0)
        n_skip = int(sz * proportion)
        k = n_skip

        start = self.head                   # head.load(ACQUIRE)
        while n_skip and start is not None:
            start = start.next
            n_skip -= 1
        if n_skip or start is None:
            return (None, None, 0)          # not enough nodes

        ssz = self.size                     # size.load(ACQUIRE)
        if ssz <= (sz - (k >> 1)):
            return (None, None, 0)          # draining too fast, abort

        begin = start.next
        start.next = None                   # THE linearization point
        # (release fence: size.fetch_add(0, RELEASE) — GIL supplies this)

        # Second traversal: count the stolen suffix (lines 30-37).
        end = begin
        count = 0
        while end is not None:
            count += 1
            if end.next is None:
                break
            end = end.next
        self.size -= count                  # size.fetch_sub(count)
        return (begin, end, count)

    def steal_optimized(self, proportion: float):
        """§IV optimized variant: if the owner made no update between the
        size snapshot and the cut (size unchanged), the stolen count is
        ``sz - cut_position`` and the tail traversal is skipped."""
        proportion = 1.0 - proportion
        sz = self.size
        if sz < self.queue_limit:
            return (None, None, 0)
        n_skip = int(sz * proportion)
        k = n_skip

        start = self.head
        while n_skip and start is not None:
            start = start.next
            n_skip -= 1
        if n_skip or start is None:
            return (None, None, 0)

        ssz = self.size
        if ssz <= (sz - (k >> 1)):
            return (None, None, 0)

        begin = start.next
        start.next = None                   # linearization point

        if self.size == sz and begin is not None:
            # Owner idle: count known from arithmetic; return immediately.
            # The cut node itself stays with the owner (begin = start->next),
            # so the stolen suffix has sz - k - 1 nodes.
            count = sz - k - 1
            self.size -= count
            return (begin, None, count)     # end not materialized (unused)

        # Fall back to the counted path.
        end = begin
        count = 0
        while end is not None:
            count += 1
            if end.next is None:
                break
            end = end.next
        self.size -= count
        return (begin, end, count)

    # -- helpers ---------------------------------------------------------------

    def drain(self) -> List[Any]:
        out = []
        while True:
            v = self.pop()
            if v is None and self.head is None:
                break
            out.append(v)
        return out

    def __len__(self) -> int:
        return self.size

    # -- HostQueue protocol adapters -------------------------------------------

    def push_bulk(self, items: Iterable[Any]) -> None:
        # The native splice consumes head-first (the batch's FIRST item
        # pops first); the protocol's deque convention is last-is-newest,
        # so pre-link in reverse.
        self.push(llist_from_iter(reversed(list(items))))

    def make_batch(self, items: Iterable[Any]):
        """Native pre-linked batch (head-first order, as in the paper's
        Listing 2 — ordering is implementation-defined here, unlike
        :meth:`push_bulk`)."""
        return llist_from_iter(items)

    def push_batch(self, prepared) -> None:
        self.push(prepared)

    def pop_item(self) -> Optional[Any]:
        return self.pop()

    def steal_bulk(self, proportion: float) -> List[Any]:
        begin, _, _count = self.steal_optimized(proportion)
        out: List[Any] = []
        node = begin
        while node is not None:
            out.append(node.payload)
            node = node.next
        return out


# ---------------------------------------------------------------------------
# Baselines (the paper compares against Taskflow's bounded/unbounded deques;
# we reproduce their *cost structure* rather than binding C++):
# ---------------------------------------------------------------------------


class PerItemDequeQueue:
    """Taskflow-unbounded-style baseline: bulk ops are simulated by repeated
    single-node operations (the inefficiency the paper calls out in §II.A).
    Owner pushes/pops at the right; the stealer takes items one at a time
    from the left, each under its own synchronization."""

    def __init__(self):
        import collections

        self._dq = collections.deque()
        self._lock = threading.Lock()

    def push(self, items) -> None:
        for it in items:                  # per-node operation, O(n) calls
            with self._lock:
                self._dq.append(it)

    def pop(self):
        with self._lock:
            return self._dq.pop() if self._dq else None

    def steal(self, proportion: float):
        with self._lock:
            n = int(len(self._dq) * proportion)
        out = []
        for _ in range(n):                # per-node steal
            with self._lock:
                if not self._dq:
                    break
                out.append(self._dq.popleft())
        return out

    def __len__(self):
        return len(self._dq)

    # -- HostQueue protocol adapters (push/steal are already list-shaped) ----

    push_bulk = push
    pop_item = pop
    steal_bulk = steal

    def make_batch(self, items):
        return list(items)

    push_batch = push


class ResizingArrayQueue:
    """Taskflow-bounded-style baseline: circular array that doubles and
    copies element-wise when full (the resizing overhead the paper's second
    requirement rejects)."""

    def __init__(self, capacity: int = 64):
        self._buf: List[Any] = [None] * capacity
        self._cap = capacity
        self._lo = 0
        self._n = 0
        self._lock = threading.Lock()

    def _grow(self) -> None:
        new = [None] * (self._cap * 2)
        for i in range(self._n):          # element-wise copy on resize
            new[i] = self._buf[(self._lo + i) % self._cap]
        self._buf, self._cap, self._lo = new, self._cap * 2, 0

    def push(self, items) -> None:
        for it in items:
            with self._lock:
                if self._n == self._cap:
                    self._grow()
                self._buf[(self._lo + self._n) % self._cap] = it
                self._n += 1

    def pop(self):
        with self._lock:
            if self._n == 0:
                return None
            self._n -= 1
            return self._buf[(self._lo + self._n) % self._cap]

    def steal(self, proportion: float):
        out = []
        with self._lock:
            n = int(self._n * proportion)
            for _ in range(n):
                out.append(self._buf[self._lo])
                self._lo = (self._lo + 1) % self._cap
                self._n -= 1
        return out

    def __len__(self):
        return self._n

    # -- HostQueue protocol adapters (push/steal are already list-shaped) ----

    push_bulk = push
    pop_item = pop
    steal_bulk = steal

    def make_batch(self, items):
        return list(items)

    push_batch = push
