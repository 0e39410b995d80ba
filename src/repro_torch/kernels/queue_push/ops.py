"""Wrappers of K2 ``ring_scatter`` (bulk push, in place) and K3
``ring_slice`` (bulk pop) for payload pytrees on stacked lanes.

For CUDA tensors, K2 (``ring_push.cu``) and K3 (``ring_slice.cu``) each
move up to ``_lib.MAX_LEAVES`` leaves of a payload tree with one launch;
for CPU tensors the plain versions in :mod:`.ref` run.  There is no other
route: a CUDA tensor the kernels refuse raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_push.ref import ring_scatter_ref, ring_slice_ref

__all__ = ["push_scatter", "pop_slice", "ring_scatter", "ring_slice",
           "ring_scatter_supported", "ring_slice_supported", "DEFAULT_BLOCK"]

# Threads of one CTA of K2 and K3: it mirrors ``ring_copy.cuh``'s
# ``kThreads`` (a test holds the two equal).  The kernels take any
# geometry their 32-bit extents hold, so no predicate reads it.
DEFAULT_BLOCK = 128


def ring_scatter_supported(capacity: int, max_push: int) -> bool:
    """Whether :func:`push_scatter` launches K2 for this geometry of int32
    items on a CUDA device: its extents within 32 bits.  The wrapper
    raises ``ValueError`` where this is False."""
    return _lib.ring_extents_fit(max(capacity, max_push), capacity, max_push)


def ring_slice_supported(capacity: int, max_n: int) -> bool:
    """Whether :func:`pop_slice` launches K3 for this geometry of int32
    items on a CUDA device: its extents within 32 bits, and a ring to pop
    from.  The wrapper raises ``ValueError`` where this is False."""
    return (capacity > 0 or max_n == 0) and _lib.ring_extents_fit(
        max(capacity, max_n), capacity, max_n)


def ring_scatter(buf: torch.Tensor, batch: torch.Tensor, start: torch.Tensor,
                 n: torch.Tensor) -> torch.Tensor:
    """One leaf, IN PLACE: ``buf[l, (start[l] + i) % cap] = batch[l, i]``
    for ``i < min(n[l], batch rows, cap)``.  Returns ``buf``."""
    return push_scatter(buf, batch, start, n)


def ring_slice(buf: torch.Tensor, lo: torch.Tensor, size: torch.Tensor,
               n: torch.Tensor, max_n: int) -> torch.Tensor:
    """One leaf: ``(L, cap, ...)`` -> ``(L, max_n, ...)``, the newest ``n``
    rows oldest first, zero after (``n`` pre-clamped to ``size``)."""
    return pop_slice(buf, lo, size, n, max_n=max_n)


def push_scatter(buf_tree, batch_tree, start: torch.Tensor, n: torch.Tensor):
    """Splice ``batch_tree[l, i] -> buf_tree[l, (start[l] + i) % cap]`` for
    ``i < min(n[l], max_push, cap)``, in place, with ``start`` taken mod
    ``cap`` as Python's ``%`` takes it; returns ``buf_tree``.

    Ring leaves are ``(lanes, cap, ...)`` and batch leaves ``(lanes,
    max_push, ...)`` of the ring's dtype and row shape, all alike;
    anything else raises ``ValueError`` before a leaf is written.  On the
    card one launch moves up to ``_lib.MAX_LEAVES`` leaves; its byte
    offsets are int32, so a lane whose ring or batch holds 2^31 bytes or
    more raises ``ValueError`` (there is no other route).
    ``push_scatter.launches`` counts the CUDA launches."""
    pairs = []
    tree_map(lambda buf, batch: pairs.append((batch, buf)), buf_tree,
             batch_tree)
    if not pairs:
        return buf_tree
    lanes, cap = pairs[0][1].shape[:2]
    max_push = pairs[0][0].shape[1]
    for batch, buf in pairs:
        if (buf.shape[:2] != (lanes, cap)
                or batch.shape[:2] != (lanes, max_push)):
            raise ValueError(f"every ring leaf must be ({lanes}, {cap}, ...) "
                             f"and every batch leaf ({lanes}, {max_push}, "
                             f"...), got {tuple(buf.shape)} and "
                             f"{tuple(batch.shape)}")
        if buf.dtype != batch.dtype or buf.shape[2:] != batch.shape[2:]:
            raise ValueError("batch rows must match the ring's rows")
    if all(buf.device.type == "cpu" for _, buf in pairs):
        n = n.clamp(0, min(max_push, cap))
        for batch, buf in pairs:
            buf.copy_(ring_scatter_ref(buf, batch, start, n))
        return buf_tree
    start = _lib.lane_vec(start, lanes, "start")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(start, n, *(t for pair in pairs for t in pair))
    if lanes == 0 or cap == 0 or max_push == 0:
        return buf_tree
    for tree in _lib.ring_trees(pairs, max(cap, max_push)):
        _lib.launch("rk_ring_scatter", tree, start.data_ptr(), n.data_ptr(),
                    lanes, cap, max_push, device=dev)
        push_scatter.launches += 1
    return buf_tree


def pop_slice(buf_tree, lo: torch.Tensor, size: torch.Tensor,
              n: torch.Tensor, *, max_n: int):
    """Detach the newest ``n`` rows of each lane (``n`` pre-clamped to
    ``size``): pytree of ``(L, max_n, ...)`` blocks, rows ``>= n``
    zeroed.  ``pop_slice.launches`` counts the CUDA launches (one per
    ``_lib.MAX_LEAVES`` leaves)."""
    pairs = []

    def one(buf):
        if buf.device.type == "cpu":
            return ring_slice_ref(buf, lo, size, n, max_n)
        out = torch.empty((buf.shape[0], max_n) + tuple(buf.shape[2:]),
                          dtype=buf.dtype, device=buf.device)
        pairs.append((buf, out))
        return out

    outs = tree_map(one, buf_tree)
    if pairs:
        _launch_slice(pairs, lo, size, n, max_n)
    return outs


def _launch_slice(pairs, lo, size, n, max_n: int) -> None:
    lanes, cap = pairs[0][0].shape[:2]
    if any(buf.shape[:2] != (lanes, cap) for buf, _ in pairs):
        raise ValueError("every leaf must be (lanes, cap, ...) alike")
    lo = _lib.lane_vec(lo, lanes, "lo")
    size = _lib.lane_vec(size, lanes, "size")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(lo, size, n, *(t for pair in pairs for t in pair))
    if lanes == 0 or max_n == 0:
        return
    if cap == 0:
        raise ValueError("cannot pop from rings of 0 rows")
    for tree in _lib.ring_trees(pairs, max(cap, max_n)):
        _lib.launch("rk_ring_slice", tree, lo.data_ptr(), size.data_ptr(),
                    n.data_ptr(), lanes, cap, max_n, device=dev)
        pop_slice.launches += 1


push_scatter.launches = 0
pop_slice.launches = 0
