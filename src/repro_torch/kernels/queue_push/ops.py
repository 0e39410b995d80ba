"""Wrappers of K2 ``ring_scatter`` (bulk push, in place) and K3
``ring_slice`` (bulk pop) for payload pytrees on stacked lanes.

For a CUDA tensor, K2 moves each ``(L, rows, ...)`` leaf with one launch of
``ring_push.cu``, and K3 moves up to ``_lib.MAX_LEAVES`` leaves of a tree
with one launch of ``ring_slice.cu``; for a CPU tensor the plain versions
in :mod:`.ref` run.  There is no other route: a CUDA tensor the kernels
refuse raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_push.ref import ring_scatter_ref, ring_slice_ref

__all__ = ["push_scatter", "pop_slice", "ring_scatter", "ring_slice"]


def ring_scatter(buf: torch.Tensor, batch: torch.Tensor, start: torch.Tensor,
                 n: torch.Tensor) -> torch.Tensor:
    """One leaf, IN PLACE: ``buf[l, (start[l] + i) % cap] = batch[l, i]``
    for ``i < min(n[l], batch rows, cap)``.  Returns ``buf``."""
    if buf.dtype != batch.dtype or buf.shape[2:] != batch.shape[2:]:
        raise ValueError("batch rows must match the ring's rows")
    lanes, cap = buf.shape[:2]
    max_push = batch.shape[1]
    if buf.device.type == "cpu":
        n = n.clamp(0, min(max_push, cap))
        return buf.copy_(ring_scatter_ref(buf, batch, start, n))
    start = _lib.lane_vec(start, lanes, "start")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(buf, batch, start, n)
    if buf.numel() == 0 or max_push == 0:
        return buf
    row_bytes = _lib.row_bytes(buf)
    word = _lib.word_bytes(row_bytes, buf, batch)
    _lib.launch("rk_ring_scatter", buf.data_ptr(), batch.data_ptr(),
                start.data_ptr(), n.data_ptr(), lanes, cap, max_push,
                row_bytes // word, word, device=dev)
    push_scatter.launches += 1
    return buf


def ring_slice(buf: torch.Tensor, lo: torch.Tensor, size: torch.Tensor,
               n: torch.Tensor, max_n: int) -> torch.Tensor:
    """One leaf: ``(L, cap, ...)`` -> ``(L, max_n, ...)``, the newest ``n``
    rows oldest first, zero after (``n`` pre-clamped to ``size``)."""
    return pop_slice(buf, lo, size, n, max_n=max_n)


def push_scatter(buf_tree, batch_tree, start: torch.Tensor, n: torch.Tensor):
    """Splice ``batch_tree[l, i] -> buf_tree[l, (start[l] + i) % cap]`` for
    ``i < n[l]``, in place; returns ``buf_tree``.
    ``push_scatter.launches`` counts the CUDA launches."""
    return tree_map(lambda b, x: ring_scatter(b, x, start, n),
                    buf_tree, batch_tree)


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
