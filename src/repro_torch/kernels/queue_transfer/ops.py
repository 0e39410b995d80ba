"""Wrapper of K4 ``ring_transfer`` (the compact exchange's thief-side
cut-and-splice, in place) for payload pytrees on stacked lanes.

Each ring leaf ``(L, cap, ...)`` and its gathered window stack
``(W, max_steal, ...)`` (read as ``(W * max_steal, ...)``, shared by all
lanes) are moved by one launch of the CUDA kernel (``ring_transfer.cu``)
for CUDA tensors, or by the plain version (``ref.ring_transfer_ref``) for
CPU tensors.  There is no other route: a CUDA tensor the kernel refuses
raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

__all__ = ["transfer_splice", "ring_transfer"]


def ring_transfer(buf: torch.Tensor, gathered: torch.Tensor,
                  head: torch.Tensor, src_row: torch.Tensor, n: torch.Tensor,
                  max_steal: int) -> torch.Tensor:
    """One leaf, IN PLACE: ``buf[l, (head[l] + i) % cap] =
    gathered[src_row[l] * max_steal + i]`` for ``i < min(n[l], max_steal,
    cap)``, with ``gathered`` of shape ``(W * max_steal, ...)``.  Returns
    ``buf``."""
    if buf.dtype != gathered.dtype or buf.shape[2:] != gathered.shape[1:]:
        raise ValueError("gathered rows must match the ring's rows")
    lanes, cap = buf.shape[:2]
    if buf.device.type == "cpu":
        n = n.clamp(0, min(max_steal, cap))
        src_start = src_row.to(torch.int64) * max_steal
        return buf.copy_(ring_transfer_ref(buf, gathered, head, src_start, n))
    head = _lib.lane_vec(head, lanes, "head")
    src_row = _lib.lane_vec(src_row, lanes, "src_row")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(buf, gathered, head, src_row, n)
    if buf.numel() == 0 or gathered.shape[0] == 0:
        return buf
    row_bytes = _lib.row_bytes(buf)
    word = _lib.word_bytes(row_bytes, buf, gathered)
    _lib.launch("rk_ring_transfer", buf.data_ptr(), gathered.data_ptr(),
                head.data_ptr(), src_row.data_ptr(), n.data_ptr(), lanes, cap,
                gathered.shape[0], max_steal, row_bytes // word, word,
                device=dev)
    transfer_splice.launches += 1
    return buf


def transfer_splice(buf_tree, gathered_tree, head: torch.Tensor,
                    src_row: torch.Tensor, n: torch.Tensor, *,
                    max_steal: int):
    """Splice ``gathered_tree[src_row[l], :n[l]]`` at ``head[l]`` of every
    lane's ring, in place; ``gathered_tree`` leaves are ``(W, max_steal,
    ...)`` window stacks.  Returns ``buf_tree``.
    ``transfer_splice.launches`` counts the CUDA launches."""
    return tree_map(
        lambda b, g: ring_transfer(b, g.reshape((-1,) + tuple(g.shape[2:])),
                                   head, src_row, n, max_steal),
        buf_tree, gathered_tree)


transfer_splice.launches = 0
