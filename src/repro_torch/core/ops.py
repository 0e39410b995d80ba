"""`BulkOps` — the single queue-operation contract, with pluggable backends.

PyTorch port of ``repro.core.ops``: one bulk-operation interface (push /
pop / pop_bulk / steal / steal_exact, plus the compact exchange's window
and transfer) whose implementations are named backends:

``"reference"``
    Plain PyTorch index arithmetic (the kernels' plain versions in
    ``kernels/*/ref.py``), no hand-written kernel.  The semantics baseline
    the kernel backend is held against.
``"cuda"``
    Every hot-path op routed through the hand-written CUDA ring kernels
    (``kernels.queue_steal`` K1, ``kernels.queue_push`` K2 / K3,
    ``kernels.queue_transfer`` K4) — the counterpart of the JAX package's
    ``"pallas"``.  The kernel wrappers launch the CUDA kernel for a CUDA
    tensor and use the plain version only for a CPU tensor.
``"auto"``
    The kernel routing of ``"cuda"``: the kernels compute every physical
    row from the lane's cursors, so no geometry needs another path (an
    extent past 32 bits raises at launch).  ``REPRO_QUEUE_BACKEND``
    (environment) overrides what ``"auto"`` resolves to, with a one-shot
    :class:`BackendFallbackWarning`; explicitly named backends are never
    overridden.
``"relaxed"``
    The fence-free steal of :mod:`repro_torch.core.relaxed` (optimistic
    window read, then reconcile), registered by ``repro_torch.core``.

``make_ops(..., check=True)`` (or ``REPRO_CHECK=1``) wraps any of them in
the runtime sanitizer, :class:`repro_torch.analysis.sanitize.CheckedBulkOps`.

Operation contract
------------------
Every op takes the :class:`QueueState` first and returns the new state
first, ``(state, ...) -> (state, batch, n)``, with the detached batch
(static leading dim, dead rows zeroed) and the count following; ``push``
and ``transfer`` return ``(state, n)``.  A state is either ONE queue
(``lo`` / ``size`` 0-d, leaves ``(cap, ...)``) or W stacked lanes
(``(W,)`` cursors, leaves ``(W, cap, ...)``); batches, counts and results
follow the same layout.  The kernels always see a lane dimension, so one
launch serves every lane.  Payloads and cursors are int32 wherever the JAX
package has int32, so byte accounting matches it.

``donate=False`` (default) leaves every input tensor untouched: an op
that writes the ring writes a copy.  ``donate=True`` writes the ring
tensors the state holds, in place, and returns them (the counterpart of
XLA's donated buffers); cursor tensors are never written in place.
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import resolve_device, tree_leaves, tree_map
from repro_torch.kernels._lib import ring_extents_fit
from repro_torch.kernels.queue_push.ops import (pop_slice, push_scatter,
                                                ring_scatter_supported,
                                                ring_slice_supported)
from repro_torch.kernels.queue_push.ref import ring_scatter_ref, ring_slice_ref
from repro_torch.kernels.queue_steal.ops import steal_gather
from repro_torch.kernels.queue_steal.ref import ring_gather_ref
from repro_torch.kernels.queue_transfer.ops import transfer_splice

__all__ = [
    "QueueState",
    "make_queue",
    "queue_size",
    "item_nbytes",
    "queue_from_numpy",
    "queue_to_numpy",
    "to_numpy",
    "from_numpy",
    "f32_scalar",
    "BulkOps",
    "make_ops",
    "register_backend",
    "available_backends",
    "steal_counted",
    "kernel_steal_available",
    "kernel_push_available",
    "kernel_pop_available",
    "kernel_transfer_available",
    "DEFAULT_QUEUE_LIMIT",
    "BACKEND_ENV_VAR",
    "CHECK_ENV_VAR",
    "BackendFallbackWarning",
    "reset_fallback_warnings",
]

Pytree = Any
I32 = torch.int32

# Default abort threshold, mirroring the paper's ``_queue_limit_``.
DEFAULT_QUEUE_LIMIT = 2

# Environment override for what "auto" resolves to.
BACKEND_ENV_VAR = "REPRO_QUEUE_BACKEND"

# Environment switch for the runtime sanitizer (``make_ops(check=None)``).
CHECK_ENV_VAR = "REPRO_CHECK"


class BackendFallbackWarning(UserWarning):
    """A requested routing silently redirected: ``REPRO_QUEUE_BACKEND``
    made ``"auto"`` resolve to another backend.  Emitted at most once per
    distinct override per process."""


_FALLBACK_WARNED: set = set()


def _warn_fallback(key: Tuple, message: str) -> None:
    if key in _FALLBACK_WARNED:
        return
    _FALLBACK_WARNED.add(key)
    warnings.warn(message, BackendFallbackWarning, stacklevel=4)


def reset_fallback_warnings() -> None:
    """Forget which one-shot fallback warnings already fired (tests)."""
    _FALLBACK_WARNED.clear()


class QueueState(NamedTuple):
    """Queue state: one queue or W stacked lanes.

    Attributes:
      buf:  pytree of ``(capacity, ...)`` or ``(W, capacity, ...)`` tensors.
      lo:   int32 physical index of the oldest element (steal side), 0-d
            or ``(W,)``.
      size: int32 number of live elements; owner side is
            ``(lo + size) % cap``.
    """

    buf: Pytree
    lo: torch.Tensor
    size: torch.Tensor


def make_queue(capacity: int, item_spec: Pytree, *,
               device=None) -> QueueState:
    """An empty queue.  ``item_spec`` is a pytree of tensors describing ONE
    item (shape and dtype; e.g. ``torch.zeros((), dtype=torch.int32)``);
    leaves get a leading ``capacity`` dimension.  ``device=None`` means
    CUDA, and raises without it."""
    dev = resolve_device(device)
    buf = tree_map(lambda s: torch.zeros((capacity,) + tuple(s.shape),
                                         dtype=s.dtype, device=dev),
                   item_spec)
    zero = torch.zeros((), dtype=I32, device=dev)
    return QueueState(buf=buf, lo=zero, size=zero.clone())


def queue_size(q: QueueState) -> torch.Tensor:
    """The number of live items: 0-d for one queue, ``(W,)`` for lanes."""
    return q.size


def item_nbytes(item_spec: Pytree) -> int:
    """Bytes per queue item: sum over the payload leaves (tensors
    describing ONE item).  The single source of truth for payload
    accounting — the master's ``bytes_moved`` and the runtime telemetry
    both derive from it."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(item_spec))


# ---------------------------------------------------------------------------
# numpy <-> torch, for feeding identical states to both packages
# ---------------------------------------------------------------------------


def from_numpy(a, device=None) -> torch.Tensor:
    """A copy of numpy array ``a`` on ``device``; bfloat16 arrays (which
    numpy holds as the ``bfloat16`` extension type) keep their bits."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 comes back as its raw ``uint16``
    bits (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def queue_from_numpy(q, device=None) -> QueueState:
    """A :class:`QueueState` (single or stacked) from any state with
    ``buf`` / ``lo`` / ``size`` holding numpy arrays — e.g. the JAX
    package's state after ``np.asarray`` — on ``device``."""
    dev = resolve_device(device)
    return QueueState(
        buf=tree_map(lambda a: from_numpy(a, dev), q.buf),
        lo=from_numpy(np.asarray(q.lo, np.int32), dev),
        size=from_numpy(np.asarray(q.size, np.int32), dev))


def queue_to_numpy(q: QueueState) -> QueueState:
    """The same state with numpy leaves (see :func:`to_numpy`)."""
    return QueueState(buf=tree_map(to_numpy, q.buf), lo=to_numpy(q.lo),
                      size=to_numpy(q.size))


# ---------------------------------------------------------------------------
# Lane layout helpers: every pure op below works on stacked lanes
# ---------------------------------------------------------------------------


def _lanes(q: QueueState) -> Tuple[QueueState, bool]:
    """``(stacked view, single)``: a single queue becomes one lane (views,
    so in-place writes reach the caller's tensors)."""
    if q.lo.dim() == 0:
        return QueueState(tree_map(lambda b: b.unsqueeze(0), q.buf),
                          q.lo.reshape(1), q.size.reshape(1)), True
    return q, False


def _unlane(tree, single: bool):
    return tree_map(lambda x: x.squeeze(0), tree) if single else tree


def _count(n, size: torch.Tensor) -> torch.Tensor:
    """A per-lane int32 count shaped like ``size`` from an int, a 0-d or a
    per-lane tensor."""
    if not isinstance(n, torch.Tensor):
        return torch.full_like(size, int(n))
    n = n.to(device=size.device, dtype=I32)
    if n.numel() == 1:
        return n.reshape(1).expand(size.shape[0]).contiguous()
    return n.reshape(size.shape).contiguous()


def _gated(n: torch.Tensor, gate: Optional[torch.Tensor]) -> torch.Tensor:
    return n if gate is None else n * gate


def _capacity(q: QueueState) -> int:
    return tree_leaves(q.buf)[0].shape[1]


def _rows(batch: Pytree) -> int:
    return tree_leaves(batch)[0].shape[1]


def f32_scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``: a float32 tensor as is, a Python
    float rounded to float32 (as JAX's weak typing rounds it), so no
    float64 enters the steal arithmetic."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Pure op implementations on stacked lanes (the semantics)
# ---------------------------------------------------------------------------


def _push(q: QueueState, batch: Pytree, n: torch.Tensor, *, kernel: bool,
          donate: bool, gate=None) -> Tuple[QueueState, torch.Tensor]:
    """Bulk push ``n`` items per lane (owner side).  ``batch`` leaves are
    ``(W, B, ...)`` with ``B >= n``; ``n`` is clamped to the free space
    (not to ``B``: rows past ``B`` are counted but not written, as in the
    JAX package).  The ``size + n`` update is the linearization point."""
    cap, bsz = _capacity(q), _rows(batch)
    n = torch.clamp(torch.minimum(n, cap - q.size), min=0)
    n = _gated(n, gate)
    start = (q.lo + q.size) % cap
    if kernel:
        buf = q.buf if donate else tree_map(torch.clone, q.buf)
        push_scatter(buf, batch, start, n)
    else:
        fill = torch.clamp(n, max=bsz)
        new = tree_map(lambda b, x: ring_scatter_ref(b, x, start, fill),
                       q.buf, batch)
        buf = (tree_map(lambda b, x: b.copy_(x), q.buf, new) if donate
               else new)
    return QueueState(buf=buf, lo=q.lo, size=q.size + n), n


def _pop(q: QueueState, gate=None
         ) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Pop the newest item per lane (owner side, LIFO); ``item`` is
    arbitrary where ``valid`` is False (empty lane)."""
    cap = _capacity(q)
    valid = q.size > 0
    if gate is not None:
        valid = valid & gate
    idx = ((q.lo + torch.clamp(q.size - 1, min=0)) % cap).long()
    lane = torch.arange(q.size.shape[0], device=q.size.device)
    item = tree_map(lambda b: b[lane, idx], q.buf)
    new_size = torch.where(valid, q.size - 1, q.size)
    return QueueState(buf=q.buf, lo=q.lo, size=new_size), item, valid


def _pop_bulk(q: QueueState, max_n: int, n: torch.Tensor, *, kernel: bool,
              gate=None) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Bulk pop up to ``n`` newest items per lane: rows ``[0, n)`` of the
    ``(W, max_n, ...)`` batch in queue order (oldest of the block first),
    rows ``>= n`` zeroed."""
    n = torch.clamp(torch.minimum(n, q.size).clamp(max=max_n), min=0)
    n = _gated(n, gate)
    if kernel:
        batch = pop_slice(q.buf, q.lo, q.size, n, max_n=max_n)
    else:
        batch = tree_map(lambda b: ring_slice_ref(b, q.lo, q.size, n, max_n),
                         q.buf)
    return QueueState(buf=q.buf, lo=q.lo, size=q.size - n), batch, n


def _gather_block(q: QueueState, n: torch.Tensor, max_steal: int,
                  kernel: bool) -> Pytree:
    """``max_steal`` rows per lane starting at ``lo`` (rows ``>= n``
    zeroed): K1 on the kernel route, its plain version otherwise."""
    if kernel:
        return steal_gather(q.buf, q.lo, n, max_steal=max_steal)
    return tree_map(lambda b: ring_gather_ref(b, q.lo, n, max_steal), q.buf)


def _steal_plan(size: torch.Tensor, proportion, queue_limit: int,
                max_steal: int, donate: bool = False) -> torch.Tensor:
    """Items to steal, following the paper's Listing 4 arithmetic:
    ``n_skip = floor(float32(size) * (1 - proportion))`` stay with the
    owner, the rest is stolen, clamped to ``[0, min(size, max_steal)]``;
    0 when ``size < queue_limit``.  ``1 - proportion`` is float32
    arithmetic for a float32 tensor and for a donating steal, and is
    rounded to float32 from a Python float otherwise, exactly as the JAX
    package computes it (its donating steal is jitted, which traces a
    Python float as float32)."""
    n = torch.minimum(
        torch.clamp(size - _keep(size, proportion, donate), min=0),
        torch.clamp(size, max=max_steal))
    return torch.where(size < queue_limit, torch.zeros_like(n), n)


def _keep(size: torch.Tensor, proportion, donate: bool = False
          ) -> torch.Tensor:
    """``floor(float32(size) * (1 - proportion))``: the items Listing 4
    leaves with the owner, in float32 (see :func:`_steal_plan`)."""
    if isinstance(proportion, torch.Tensor) or donate:
        keep_frac = 1.0 - f32_scalar(proportion, size.device)
    else:
        keep_frac = f32_scalar(1.0 - float(proportion), size.device)
    return torch.floor(size.to(torch.float32) * keep_frac).to(I32)


def _steal(q: QueueState, proportion, *, max_steal: int, queue_limit: int,
           kernel: bool, gate=None, donate: bool = False
           ) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Bulk steal of ``~proportion`` of each lane from the tail (oldest
    side).  The single ``lo += n`` cursor bump is the linearization
    point.  ``donate`` picks the rounding of a Python-float proportion
    (see :func:`_steal_plan`); a steal writes no ring."""
    cap = _capacity(q)
    n = _gated(_steal_plan(q.size, proportion, queue_limit, max_steal,
                           donate), gate)
    batch = _gather_block(q, n, max_steal, kernel)
    return (QueueState(buf=q.buf, lo=(q.lo + n) % cap, size=q.size - n),
            batch, n)


def _steal_exact(q: QueueState, n: torch.Tensor, *, max_steal: int,
                 kernel: bool, gate=None
                 ) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Steal exactly ``n`` items per lane (clamped to size / ``max_steal``)
    from the tail; rows ``>= n`` of the batch are zeroed."""
    cap = _capacity(q)
    n = torch.minimum(torch.clamp(n, min=0),
                      torch.clamp(q.size, max=max_steal))
    n = _gated(n, gate)
    batch = _gather_block(q, n, max_steal, kernel)
    return (QueueState(buf=q.buf, lo=(q.lo + n) % cap, size=q.size - n),
            batch, n)


def _window(q: QueueState, *, max_steal: int, kernel: bool) -> Pytree:
    """Raw tail window: rows ``(lo + i) % cap`` for ``i < max_steal``,
    UNMASKED — the victim's contribution to the compact exchange (rows
    past ``size`` are dead weight the thief never reads)."""
    return _gather_block(q, torch.full_like(q.size, max_steal), max_steal,
                         kernel)


def _transfer(q: QueueState, gathered: Pytree, src_row: torch.Tensor,
              n: torch.Tensor, *, max_steal: int, kernel: bool,
              donate: bool, gate=None) -> Tuple[QueueState, torch.Tensor]:
    """Thief-side fused cut-and-splice: splice ``gathered[src_row[l],
    :n[l]]`` (each ``gathered`` leaf is ONE ``(W_src, max_steal, ...)``
    stack of windows, shared by all lanes) at the owner end of lane ``l``.
    Semantically ``push(q, gathered[src_row], n)``; the kernel route (K4)
    reads the stack directly, so the selected block never exists.  ``n``
    is clamped to the free space and ``max_steal``, like ``push``."""
    cap = _capacity(q)
    n = torch.clamp(torch.minimum(n, torch.clamp(cap - q.size,
                                                 max=max_steal)), min=0)
    n = _gated(n, gate)
    if kernel:
        buf = q.buf if donate else tree_map(torch.clone, q.buf)
        transfer_splice(buf, gathered, (q.lo + q.size) % cap, src_row, n,
                        max_steal=max_steal)
        return QueueState(buf=buf, lo=q.lo, size=q.size + n), n
    # Reference route IS "select the victim's window, then push"; the
    # select clamps its index like JAX's dynamic_index_in_dim.
    sel = src_row.long().clamp(0, tree_leaves(gathered)[0].shape[0] - 1)
    batch = tree_map(lambda g: g[sel], gathered)
    return _push(q, batch, n, kernel=False, donate=donate)


def steal_counted(q: QueueState, proportion, *, max_steal: int,
                  queue_limit: int = DEFAULT_QUEUE_LIMIT
                  ) -> Tuple[QueueState, Pytree, torch.Tensor]:
    """Paper-faithful *non-optimized* steal: the same steal, then an
    explicit sequential walk over the stolen segment to (re)count it —
    one dependent device step per row, mirroring the second list walk of
    Listing 4 lines 30-37.  Exists so benchmarks can reproduce Fig. 8's
    gap; always the reference gather."""
    qs, single = _lanes(q)
    qs, batch, n = _steal(qs, proportion, max_steal=max_steal,
                          queue_limit=queue_limit, kernel=False)
    count = torch.zeros_like(n)
    for i in range(max_steal):
        count = count + (n > i).to(I32)
    return _unlane(qs, single), _unlane(batch, single), _unlane(count, single)


# ---------------------------------------------------------------------------
# Geometry predicates: whether the CUDA kernels serve a geometry.  They
# take any geometry their 32-bit extents hold (rows of one int32 item),
# so "auto" never needs another route; the wrappers raise where these are
# False.
# ---------------------------------------------------------------------------


def kernel_push_available(capacity: int, max_push: int) -> bool:
    """Whether K2 serves a bulk push of this geometry."""
    return ring_scatter_supported(capacity, max_push)


def kernel_pop_available(capacity: int, max_n: int) -> bool:
    """Whether K3 serves a bulk pop of this geometry."""
    return ring_slice_supported(capacity, max_n)


def kernel_steal_available(capacity: int, max_steal: int) -> bool:
    """Whether K1 serves a steal (or a window read) of this geometry: a
    ring to read, and its extents within 32 bits."""
    return (capacity > 0 or max_steal == 0) and ring_extents_fit(
        max(capacity, max_steal), capacity, max_steal)


def kernel_transfer_available(capacity: int, max_steal: int) -> bool:
    """Whether K4 serves the compact exchange's thief-side cut-and-splice
    of this geometry: its extents within 32 bits."""
    return ring_extents_fit(max(capacity, max_steal), capacity, max_steal)


# ---------------------------------------------------------------------------
# The backend object
# ---------------------------------------------------------------------------


class BulkOps:
    """One queue-operation backend: the paper's bulk push/pop/steal
    contract with a fixed routing.

    ``kernel`` is the whole configuration: True routes every op through
    the CUDA ring kernels (whose wrappers take the plain versions only for
    CPU tensors), False through the plain versions everywhere.  Obtain
    instances via :func:`make_ops`; compare routing with :attr:`resolved`
    (``"cuda"`` / ``"reference"``).

    :meth:`gated` scopes a device-side flag over every op: while the flag
    is False each op moves zero items, so the kernels launch and write
    nothing and every cursor stays where it was — how the runtime makes
    the rounds of a fused block past the drain into no-ops without
    reading the flag on the host.
    """

    # True only for the sanitizer's wrapper: the runtime, the superstep
    # and PagedQueue arm their own checks exactly when it is set.
    checked = False

    def __init__(self, name: str, *, kernel: bool):
        self.name = name
        self.kernel = bool(kernel)
        self._gate: Optional[torch.Tensor] = None

    @property
    def resolved(self) -> str:
        """The effective routing: which implementation family serves ops."""
        return "cuda" if self.kernel else "reference"

    def __repr__(self) -> str:
        return f"BulkOps({self.name!r}, kernel={self.kernel})"

    def __eq__(self, other) -> bool:
        return isinstance(other, BulkOps) and self.resolved == other.resolved

    def __hash__(self) -> int:
        return hash(self.resolved)

    @contextlib.contextmanager
    def gated(self, active: torch.Tensor):
        """Within the block, every op's item count is multiplied by the
        0-d bool tensor ``active``."""
        prev, self._gate = self._gate, active
        try:
            yield self
        finally:
            self._gate = prev

    # -- operations ----------------------------------------------------------

    def push(self, q: QueueState, batch: Pytree, n, *,
             donate: bool = False) -> Tuple[QueueState, torch.Tensor]:
        """Bulk push ``n`` items; returns ``(state, n_pushed)``."""
        qs, single = _lanes(q)
        batch = tree_map(lambda x: x.unsqueeze(0), batch) if single else batch
        qs, n = _push(qs, batch, _count(n, qs.size), kernel=self.kernel,
                      donate=donate, gate=self._gate)
        return _unlane(qs, single), _unlane(n, single)

    def pop(self, q: QueueState, *, donate: bool = False
            ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        """Pop the newest item; returns ``(state, item, valid)``.  A pop
        writes no ring, so ``donate`` changes nothing."""
        del donate
        qs, single = _lanes(q)
        qs, item, valid = _pop(qs, gate=self._gate)
        return _unlane(qs, single), _unlane(item, single), \
            _unlane(valid, single)

    def pop_bulk(self, q: QueueState, max_n: int, n, *,
                 donate: bool = False
                 ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        """Bulk pop up to ``n`` newest items; returns
        ``(state, batch, n_popped)`` with ``batch`` rows >= n zeroed."""
        del donate
        qs, single = _lanes(q)
        qs, batch, n = _pop_bulk(qs, max_n, _count(n, qs.size),
                                 kernel=self.kernel, gate=self._gate)
        return _unlane(qs, single), _unlane(batch, single), \
            _unlane(n, single)

    def steal(self, q: QueueState, proportion, *, max_steal: int,
              queue_limit: int = DEFAULT_QUEUE_LIMIT,
              donate: bool = False
              ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        """Proportional bulk steal from the tail; returns
        ``(state, batch, n_stolen)``.  A steal writes no ring: ``donate``
        only rounds a Python-float proportion to float32 before ``1 - p``,
        as the JAX package's jitted donating steal does."""
        qs, single = _lanes(q)
        qs, batch, n = _steal(qs, proportion, max_steal=max_steal,
                              queue_limit=queue_limit,
                              kernel=self.kernel, gate=self._gate,
                              donate=donate)
        return _unlane(qs, single), _unlane(batch, single), \
            _unlane(n, single)

    def steal_exact(self, q: QueueState, n, *, max_steal: int,
                    donate: bool = False
                    ) -> Tuple[QueueState, Pytree, torch.Tensor]:
        """Steal exactly ``n`` items (clamped); returns
        ``(state, batch, n_stolen)``."""
        del donate
        qs, single = _lanes(q)
        qs, batch, n = _steal_exact(qs, _count(n, qs.size),
                                    max_steal=max_steal,
                                    kernel=self.kernel,
                                    gate=self._gate)
        return _unlane(qs, single), _unlane(batch, single), \
            _unlane(n, single)

    def window(self, q: QueueState, *, max_steal: int,
               donate: bool = False) -> Pytree:
        """Raw (unmasked) ``max_steal``-row tail window at ``lo`` — the
        victim-side contribution to the compact exchange.  Pure read."""
        del donate
        qs, single = _lanes(q)
        return _unlane(_window(qs, max_steal=max_steal,
                               kernel=self.kernel), single)

    def transfer(self, q: QueueState, gathered: Pytree, src_row, n, *,
                 max_steal: int, donate: bool = False
                 ) -> Tuple[QueueState, torch.Tensor]:
        """Fused thief-side cut-and-splice: push ``gathered[src_row, :n]``
        (leaves ``(W_src, max_steal, ...)``, one stack for all lanes) at
        the owner end without materializing the selected block; returns
        ``(state, n_spliced)``."""
        qs, single = _lanes(q)
        qs, n = _transfer(qs, gathered, _count(src_row, qs.size),
                          _count(n, qs.size), max_steal=max_steal,
                          kernel=self.kernel, donate=donate,
                          gate=self._gate)
        return _unlane(qs, single), _unlane(n, single)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# A factory takes the geometry keywords of make_ops and returns a BulkOps.
BackendFactory = Callable[..., BulkOps]

_REGISTRY: Dict[str, BackendFactory] = {}


def register_backend(name: str, factory: BackendFactory) -> None:
    """Register a named backend factory.  The factory receives the
    geometry keywords of :func:`make_ops` (``capacity`` / ``max_steal``,
    each possibly ``None``)."""
    _REGISTRY[name] = factory


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# The kernels compute every physical row from the lane's cursors, so the
# fenced routings take no geometry (an extent past 32 bits raises at
# launch); only the relaxed backend's predicate reads it.
register_backend("reference", lambda **_: BulkOps("reference", kernel=False))
register_backend("cuda", lambda **_: BulkOps("cuda", kernel=True))
register_backend("auto", lambda **_: BulkOps("auto", kernel=True))


def _env_check() -> bool:
    return os.environ.get(CHECK_ENV_VAR, "").strip().lower() in (
        "1", "true", "yes", "on")


def make_ops(backend: Optional[str] = "auto", *,
             capacity: Optional[int] = None,
             max_steal: Optional[int] = None,
             check: Optional[bool] = None) -> BulkOps:
    """Construct a :class:`BulkOps` backend.

    ``backend`` is a registry name or an existing :class:`BulkOps`
    (returned unchanged, or wrapped when ``check``).  ``"auto"`` (also
    ``None``) is the kernel routing unless the ``REPRO_QUEUE_BACKEND``
    environment variable names another backend; explicit names are never
    overridden.  The geometry keywords reach the backend's factory; only
    ``"relaxed"`` reads them (its window must fit the ring).

    ``check=True`` (default: the ``REPRO_CHECK`` environment switch)
    wraps the backend in the runtime sanitizer
    (:class:`repro_torch.analysis.sanitize.CheckedBulkOps`): every op
    validated against the sequential contract, lane by lane.
    """
    if check is None:
        check = _env_check()
    if isinstance(backend, BulkOps):
        return _maybe_checked(backend, check)
    if backend is None:
        backend = "auto"
    if backend == "auto":
        env = os.environ.get(BACKEND_ENV_VAR, "").strip()
        if env and env != "auto":
            _warn_fallback(
                ("env", env),
                f"auto resolved to {env!r} via the {BACKEND_ENV_VAR} "
                f"environment override")
            backend = env
    try:
        factory = _REGISTRY[backend]
    except KeyError:
        raise ValueError(
            f"unknown queue backend {backend!r}; "
            f"available: {available_backends()}") from None
    ops = factory(capacity=capacity, max_steal=max_steal)
    return _maybe_checked(ops, check)


def _maybe_checked(ops: BulkOps, check: bool) -> BulkOps:
    if not check:
        return ops
    from repro_torch.analysis.sanitize import CheckedBulkOps  # no cycle

    if isinstance(ops, CheckedBulkOps):
        return ops
    return CheckedBulkOps(ops)
