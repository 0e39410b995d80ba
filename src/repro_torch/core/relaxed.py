"""``"relaxed"`` — a fence-free, multiplicity-tolerant BulkOps backend
(PyTorch port of ``repro.core.relaxed``).

Castañeda & Piña's relaxed work-stealing queues drop the store-load fence
on the steal path by letting a steal *over-report*: the stealer claims a
block from a possibly stale view of the queue, at most a fixed window of
entries can be claimed beyond what the owner still agrees exists, and the
claim is reconciled afterwards.

The port keeps the JAX package's dataflow:

* the fenced steal fixes the stolen count ``n`` from the size first and
  then gathers exactly that block (count before data);
* the relaxed steal reads the WHOLE ``max_steal``-row tail window first —
  unmasked, no count consulted: K1 with ``n = max_steal``, the compact
  exchange's window read — and then settles the claim against the
  owner's size in a separate step that zeroes the over-claimed rows and
  bumps the cursor by the settled count (data before count).

The observable contract equals the fenced backends' (the parity tests
sweep ``"relaxed"`` beside ``"reference"`` and ``"cuda"``).  Every other
op (push, pop, pop_bulk, window, transfer) takes the kernel routing, as
``"auto"`` does; on CPU tensors every kernel wrapper runs its plain
version.

Registry drop-in: ``make_ops("relaxed", capacity=..., max_steal=...)``.
:func:`relaxed_supported` is a semantic predicate, not a tiling one: the
window must fit the ring.  An unknown geometry or a window larger than
the ring falls back to the fenced kernel routing under the same name,
with one :class:`~repro_torch.core.ops.BackendFallbackWarning`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.core import ops as bulk_ops
from repro_torch.core.ops import (I32, QueueState, _capacity, _count, _gated,
                                  _keep, _lanes, _unlane, _window)

__all__ = ["RelaxedBulkOps", "relaxed_supported", "optimistic_read",
           "reconcile"]

Pytree = object


def relaxed_supported(capacity: Optional[int],
                      max_steal: Optional[int]) -> bool:
    """Whether the optimistic full-window steal can serve this geometry:
    the window must be real rows (``0 < max_steal <= capacity``), else the
    unmasked read would wrap onto itself and an over-reported row could
    alias a live one.  Unknown geometry is unsupported."""
    return (capacity is not None and max_steal is not None
            and 0 < int(max_steal) <= int(capacity))


def _reconcile(qs: QueueState, window: Pytree, claim: torch.Tensor,
               max_steal: int, *, floor=None, gate=None
               ) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """The posterior repair on stacked lanes: settle ``claim`` at
    ``min(clip(claim, 0, max_steal), size)``, then at most
    ``max(floor, 0)``; zero the window's rows past the settled count and
    bump ``lo`` by it.

    ``floor`` is the stable-prefix bound of the split-step protocol: the
    least owner-visible size since the optimistic read.  The first
    ``floor`` rows of the window are slots no owner push or pop has
    touched since the read, so the settle extracts only live, current
    rows; without it a pop-then-push owner schedule would hand out stale
    bytes and lose the refilled items.  The atomic steal (``floor=None``)
    needs no clamp: nothing runs between its read and its reconcile."""
    cap = _capacity(qs)
    n = torch.minimum(torch.clamp(_count(claim, qs.size), 0, max_steal),
                      qs.size)
    if floor is not None:
        n = torch.minimum(n, torch.clamp(_count(floor, qs.size), min=0))
    n = _gated(n, gate)
    offs = torch.arange(max_steal, dtype=I32, device=qs.size.device)

    def withdraw(x):
        live = (offs[None, :] < n[:, None]).reshape(
            (x.shape[0], max_steal) + (1,) * (x.dim() - 2))
        return torch.where(live, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    batch = tree_map(withdraw, window)
    return (QueueState(buf=qs.buf, lo=(qs.lo + n) % cap, size=qs.size - n),
            batch, n)


def optimistic_read(q: QueueState, max_steal: int) -> Pytree:
    """Step one of the split-step steal: the fence-free unmasked window
    of ``max_steal`` rows at ``lo`` (K1 on CUDA tensors).  Public so the
    model checker can interleave owner ops between the two steps."""
    qs, single = _lanes(q)
    return _unlane(_window(qs, max_steal=max_steal, kernel=True), single)


def reconcile(q: QueueState, window: Pytree, claim, max_steal: int, *,
              floor=None) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Step two of the split-step steal: settle ``claim`` against the
    CURRENT owner state ``q``, clamped to the stable-prefix ``floor``
    (see :func:`_reconcile`).  Returns ``(new_state, batch, n)`` with the
    over-claimed rows zeroed."""
    qs, single = _lanes(q)
    if single:
        window = tree_map(lambda x: x.unsqueeze(0), window)
    qs, batch, n = _reconcile(qs, window, claim, max_steal, floor=floor)
    return _unlane(qs, single), _unlane(batch, single), _unlane(n, single)


class RelaxedBulkOps(bulk_ops.BulkOps):
    """The fence-free backend: optimistic steal ops; the owner and thief
    sides (push, pop, pop_bulk, window, transfer) keep the fenced kernel
    routing."""

    def __init__(self):
        super().__init__("relaxed", kernel=True)

    @property
    def resolved(self) -> str:
        return "relaxed"

    def __repr__(self) -> str:
        return "RelaxedBulkOps()"

    def __eq__(self, other) -> bool:
        return type(other) is RelaxedBulkOps

    def __hash__(self) -> int:
        return hash((RelaxedBulkOps, self.kernel))

    def multiplicity_bound(self, max_steal: int) -> int:
        """The most rows a steal may transiently over-report before the
        reconcile withdraws them: the whole window (a claim can settle as
        low as 0)."""
        return int(max_steal)

    def _settle(self, q, claim_of, max_steal: int):
        qs, single = _lanes(q)
        window = _window(qs, max_steal=max_steal, kernel=True)  # data ...
        qs, batch, n = _reconcile(qs, window, claim_of(qs), max_steal,
                                  gate=self._gate)  # ... then the count
        return _unlane(qs, single), _unlane(batch, single), \
            _unlane(n, single)

    def steal(self, q: QueueState, proportion, *, max_steal: int,
              queue_limit: int = bulk_ops.DEFAULT_QUEUE_LIMIT,
              donate: bool = False
              ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        """The claim is Listing 4's arithmetic without the fenced clamp:
        keep ``floor(float32(size) * (1 - p))``, claim the rest.  A steal
        writes no ring; ``donate`` rounds a Python-float ``p`` as the fenced
        steal does."""

        def claim(qs):
            size = qs.size
            return torch.where(size < queue_limit, torch.zeros_like(size),
                               size - _keep(size, proportion, donate))

        return self._settle(q, claim, max_steal)

    def steal_exact(self, q: QueueState, n, *, max_steal: int,
                    donate: bool = False
                    ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        del donate
        return self._settle(q, lambda qs: _count(n, qs.size), max_steal)


def _relaxed_factory(*, capacity: Optional[int] = None,
                     max_steal: Optional[int] = None) -> bulk_ops.BulkOps:
    if relaxed_supported(capacity, max_steal):
        return RelaxedBulkOps()
    if capacity is None or max_steal is None:
        reason = (f"geometry unknown (capacity={capacity}, "
                  f"max_steal={max_steal})")
    else:
        reason = (f"the multiplicity window does not fit the ring "
                  f"(max_steal={max_steal} > capacity={capacity})")
    bulk_ops._warn_fallback(
        ("relaxed", capacity, max_steal),
        f"relaxed falls back to the fenced kernel routing: {reason}")
    return bulk_ops.BulkOps("relaxed", kernel=True)


bulk_ops.register_backend("relaxed", _relaxed_factory)
