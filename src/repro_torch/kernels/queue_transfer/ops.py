"""Wrapper of K4 ``ring_transfer`` (the compact exchange's thief-side
cut-and-splice, in place) for payload pytrees on stacked lanes.

Every ring leaf ``(L, cap, ...)`` of a CUDA payload tree and its gathered
window stack ``(W, max_steal, ...)`` (read as ``(W * max_steal, ...)``,
shared by all lanes) are moved by one launch of the CUDA kernel
(``ring_transfer.cu``), up to ``_lib.MAX_LEAVES`` leaves per launch; a CPU
leaf is moved by the plain version (``ref.ring_transfer_ref``).  There is
no other route: a CUDA tensor the kernel refuses raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

__all__ = ["transfer_splice", "ring_transfer"]


def transfer_splice(buf_tree, gathered_tree, head: torch.Tensor,
                    src_row: torch.Tensor, n: torch.Tensor, *,
                    max_steal: int):
    """Splice ``gathered_tree[src_row[l], :n[l]]`` at ``head[l]`` of every
    lane's ring, in place; ``gathered_tree`` leaves are ``(W, max_steal,
    ...)`` window stacks, and a ``src_row`` in ``[-W, 0)`` picks window
    ``src_row + W``, as Python indexing does.  Below ``-W`` a lane with rows
    to splice (``n > 0``) raises: ``ValueError`` for CPU tensors; on the
    card the kernel traps, and PyTorch raises at the next synchronisation,
    as for an index its own CUDA indexing refuses.  A lane with ``n = 0``
    reads nothing and is never refused.
    Returns ``buf_tree``.
    ``transfer_splice.launches`` counts the CUDA launches (one per
    ``_lib.MAX_LEAVES`` leaves)."""
    flat = tree_map(lambda g: g.reshape((-1,) + tuple(g.shape[2:])),
                    gathered_tree)
    _splice(buf_tree, flat, head, src_row, n, max_steal)
    return buf_tree


def ring_transfer(buf: torch.Tensor, gathered: torch.Tensor,
                  head: torch.Tensor, src_row: torch.Tensor, n: torch.Tensor,
                  max_steal: int) -> torch.Tensor:
    """One leaf, IN PLACE: ``buf[l, (head[l] + i) % cap] =
    gathered[src_row[l] * max_steal + i]`` for ``i < min(n[l], max_steal,
    cap)``, with ``gathered`` of shape ``(S, ...)``; a source row past ``S``
    reads row ``S - 1``, and a negative ``src_row`` counts from the end of
    the stack, as Python indexing does (below ``-S / max_steal`` it
    raises, as in :func:`transfer_splice`).  Returns ``buf``."""
    _splice(buf, gathered, head, src_row, n, max_steal)
    return buf


def _splice(buf_tree, flat_tree, head, src_row, n, max_steal: int) -> None:
    leaves = tree_leaves(flat_tree)
    if src_row.device.type == "cpu" and leaves and max_steal:
        # Only lanes with rows to splice read the stack.  On the card the
        # kernel checks each such lane itself (ring_transfer.cu): a
        # read-back here would stall every call.
        rows, count = torch.broadcast_tensors(src_row, n)
        reading = rows[count > 0]
        lowest = int(reading.min()) if reading.numel() else 0
        if lowest * max_steal < -leaves[0].shape[0]:
            raise ValueError(f"src_row {lowest}: its rows would start before "
                             f"the {leaves[0].shape[0]}-row stack")
    pairs = []

    def one(buf, gathered):
        if buf.dtype != gathered.dtype or buf.shape[2:] != gathered.shape[1:]:
            raise ValueError("gathered rows must match the ring's rows")
        if buf.device.type == "cpu":
            cap = buf.shape[1]
            live = n.clamp(0, min(max_steal, cap))
            src_start = src_row.to(torch.int64) * max_steal
            buf.copy_(ring_transfer_ref(buf, gathered, head, src_start, live))
        else:
            pairs.append((gathered, buf))

    tree_map(one, buf_tree, flat_tree)
    if not pairs:
        return
    lanes, cap = pairs[0][1].shape[:2]
    src_rows = pairs[0][0].shape[0]
    if any(buf.shape[:2] != (lanes, cap) or g.shape[0] != src_rows
           for g, buf in pairs):
        raise ValueError("every leaf must be (lanes, cap, ...) alike, with "
                         "stacks of as many rows")
    head = _lib.lane_vec(head, lanes, "head")
    src_row = _lib.lane_vec(src_row, lanes, "src_row")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(head, src_row, n, *(t for p in pairs for t in p))
    if lanes == 0 or cap == 0 or max_steal == 0 or src_rows == 0:
        return
    for tree in _lib.ring_trees(pairs, max(cap, src_rows)):
        _lib.launch("rk_ring_transfer", tree, head.data_ptr(),
                    src_row.data_ptr(), n.data_ptr(), lanes, cap, src_rows,
                    max_steal, device=dev)
        transfer_splice.launches += 1


transfer_splice.launches = 0
