"""The module-level single pop and host paging (PyTorch port of
``repro.core.queue``).

The queue is a ring of static shape on the device (``core/ops.py``);
the paper's queue grows without bounds, and :class:`PagedQueue` gives a
ring that: when a bulk push would overflow it, the oldest block of the
ring is spilled to a host page in one bulk copy (``.cpu()``); when the
ring drains to its low watermark, the newest page is spliced back in
(``.to(device)``).  The stealer may take whole host pages, the cheapest
bulk steal there is.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch._tree import resolve_device, tree_leaves, tree_map
from repro_torch.core.ops import (DEFAULT_QUEUE_LIMIT, BulkOps, QueueState,
                                  _lanes, _pop, _unlane, f32_scalar,
                                  kernel_pop_available, kernel_push_available,
                                  kernel_steal_available, make_ops,
                                  make_queue, queue_size, steal_counted)

__all__ = ["QueueState", "make_queue", "queue_size", "pop", "steal_counted",
           "kernel_steal_available", "kernel_push_available",
           "kernel_pop_available", "PagedQueue"]

Pytree = Any


def pop(q: QueueState) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Pop the newest item per lane (owner side, LIFO).  Returns
    ``(new_state, item, valid)``; ``item`` is arbitrary where ``valid`` is
    False.  No backend chooses anything here: there is no kernel."""
    qs, single = _lanes(q)
    qs, item, valid = _pop(qs)
    return _unlane(qs, single), _unlane(item, single), _unlane(valid, single)


def _host(tree: Pytree) -> Pytree:
    """A host page of ``tree``: a copy, whatever device it lies on."""
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


class PagedQueue:
    """Device ring + host overflow pages: unbounded growth, static shapes.

    Host-level orchestration: every public op reads counts back (that is
    its contract), so it stays off the solver's path.  The device ops run
    through a :class:`~repro_torch.core.ops.BulkOps` backend with
    ``donate=True`` (the ring written in place); ``backend`` is a
    registry name or an existing ``BulkOps``.  ``device=None`` means
    CUDA.  Pages are ``(batch, n)``: a host batch whose first ``n`` rows
    are items.
    """

    def __init__(self, capacity: int, item_spec: Pytree, *,
                 low_watermark: int | None = None,
                 backend: str | BulkOps = "auto", device=None):
        self.capacity = int(capacity)
        self.low_watermark = int(low_watermark if low_watermark is not None
                                 else capacity // 4)
        self.device = resolve_device(device)
        self.state = make_queue(capacity, item_spec, device=self.device)
        self.pages: List[Tuple[Pytree, int]] = []
        self._spill_n = self.capacity // 2
        self.ops = make_ops(backend, capacity=self.capacity,
                            max_steal=self._spill_n)
        # Spill/refill accounting (the sanitizer's PagedQueue contract):
        # paging moves items between ring and host pages, so the net
        # external flow pushed - popped - stolen must equal total_size()
        # after every public op.  Armed exactly when make_ops wrapped the
        # backend (REPRO_CHECK=1 / check=True).
        self._check = self.ops.checked
        self._net_in = 0
        # Paging traffic: one spill per host page written, one refill per
        # page spliced back, with the item counts each way.
        self.spills = 0
        self.spilled_items = 0
        self.refills = 0
        self.refilled_items = 0

    def _audit(self, context: str) -> None:
        if not self._check:
            return
        from repro_torch.analysis import sanitize

        size = int(self.state.size)
        if not 0 <= size <= self.capacity:
            sanitize.record_violation(
                f"PagedQueue.{context}: ring size {size} outside "
                f"[0, {self.capacity}]", eager=True)
        for batch, n in self.pages:
            rows = tree_leaves(batch)[0].shape[0]
            if n <= 0 or n > rows:
                sanitize.record_violation(
                    f"PagedQueue.{context}: host page count {n} outside "
                    f"(0, rows={rows}]", eager=True)
        if self.total_size() != self._net_in:
            sanitize.record_violation(
                f"PagedQueue.{context}: spill/refill accounting broken — "
                f"total_size()={self.total_size()} but net external flow "
                f"is {self._net_in} (items lost or duplicated while "
                f"paging)", eager=True)

    def _p(self, proportion: float) -> torch.Tensor:
        """A steal proportion as a float32 tensor, so ``1 - p`` is taken
        after rounding ``p`` to float32, as the JAX package's donating
        (jitted) steal receives it."""
        return f32_scalar(proportion, self.device)

    # -- owner side ---------------------------------------------------------

    def push(self, batch: Pytree, n: int) -> None:
        size = int(self.state.size)
        if size + n > self.capacity:
            # Spill the oldest block to a host page (one bulk copy).  The
            # proportion is capped at 1.0: a nearly empty ring spills what
            # it has, never more.
            self.state, spilled, n_sp = self.ops.steal(
                self.state, self._p(min(1.0, self._spill_n / max(size, 1))),
                max_steal=self._spill_n, queue_limit=0, donate=True)
            n_sp = int(n_sp)
            if n_sp:
                self.pages.append((_host(spilled), n_sp))
                self.spills += 1
                self.spilled_items += n_sp
        self.state, pushed = self.ops.push(self.state, batch, n, donate=True)
        pushed = int(pushed)
        if pushed < n:  # the ring is still too small: page the rest
            self.pages.append((_host(tree_map(lambda x: x[pushed:], batch)),
                               n - pushed))
            self.spills += 1
            self.spilled_items += n - pushed
        self._net_in += int(n)
        self._audit("push")

    def pop(self):
        self._maybe_refill()
        self.state, item, valid = self.ops.pop(self.state, donate=True)
        valid = bool(valid)
        if valid:
            self._net_in -= 1
        self._audit("pop")
        return item, valid

    def _maybe_refill(self) -> None:
        if int(self.state.size) <= self.low_watermark and self.pages:
            batch, n = self.pages.pop()
            dev = tree_map(lambda x: x.to(self.device), batch)
            self.state, pushed = self.ops.push(self.state, dev, n,
                                               donate=True)
            pushed = int(pushed)
            self.refills += 1
            self.refilled_items += pushed
            if pushed < n:
                # A page larger than the ring's free space: keep its
                # un-spliced tail as a smaller host page, never drop it.
                self.pages.append((tree_map(lambda x: x[pushed:], batch),
                                   n - pushed))

    # -- stealer side -------------------------------------------------------

    def total_size(self) -> int:
        return int(self.state.size) + sum(n for _, n in self.pages)

    def steal(self, proportion: float) -> List[Tuple[Pytree, int]]:
        """Bulk steal: whole host pages first (no device traffic), oldest
        first, then a steal from the device ring."""
        want = int(self.total_size() * proportion)
        got: List[Tuple[Pytree, int]] = []
        while self.pages and want > 0:
            batch, n = self.pages.pop(0)
            got.append((batch, n))
            want -= n
        size = int(self.state.size)
        if want > 0 and size >= DEFAULT_QUEUE_LIMIT:
            self.state, batch, n = self.ops.steal(
                self.state, self._p(want / max(size, 1)),
                max_steal=self._spill_n, queue_limit=0, donate=True)
            n = int(n)
            if n:
                got.append((_host(batch), n))
        self._net_in -= sum(n for _, n in got)
        self._audit("steal")
        return got

    # -- HostQueue protocol adapters (int payload convenience) --------------

    def push_bulk(self, items) -> None:
        """Protocol adapter: push a list of int items (rings of one int32
        leaf only)."""
        self.push_batch(self.make_batch(items))

    def make_batch(self, items):
        """Producer-side prep: host list -> device tensor."""
        items = list(items)
        return (torch.tensor(items, dtype=torch.int32, device=self.device),
                len(items))

    def push_batch(self, prepared) -> None:
        batch, n = prepared
        if n:
            self.push(batch, n)

    def pop_item(self):
        item, valid = self.pop()
        return int(item) if valid else None

    def steal_bulk(self, proportion: float) -> list:
        """Protocol adapter over :meth:`steal`.  Page-granular: whole host
        pages move first, so the stolen amount rounds up to page
        boundaries, and overflow pages hold the NEWEST items (see
        :class:`~repro_torch.core.host_queue.HostQueue`)."""
        out: list = []
        for batch, n in self.steal(proportion):
            out.extend(int(x) for x in batch.reshape(-1)[:n].tolist())
        return out

    def __len__(self) -> int:
        return self.total_size()
