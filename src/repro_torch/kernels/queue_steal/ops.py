"""Wrapper of K1 ``ring_gather`` for payload pytrees on stacked lanes.

Each ``(L, cap, ...)`` leaf is read as ``(L, cap, row_bytes)`` and moved by
one launch of the CUDA kernel (``ring_gather.cu``) for a CUDA tensor, or by
the plain version (``ref.ring_gather_ref``) for a CPU tensor.  There is no
other route: a CUDA tensor the kernel refuses raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_steal.ref import ring_gather_ref

__all__ = ["steal_gather", "ring_gather"]


def ring_gather(buf: torch.Tensor, lo: torch.Tensor, n: torch.Tensor,
                max_steal: int) -> torch.Tensor:
    """One leaf: ``(L, cap, ...)`` -> ``(L, max_steal, ...)``, rows
    ``(lo + i) % cap`` for ``i < n``, zero after."""
    if buf.device.type == "cpu":
        return ring_gather_ref(buf, lo, n, max_steal)
    lanes, cap = buf.shape[:2]
    lo = _lib.lane_vec(lo, lanes, "lo")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(buf, lo, n)
    out = torch.empty((lanes, max_steal) + tuple(buf.shape[2:]),
                      dtype=buf.dtype, device=dev)
    if out.numel() == 0:
        return out
    row_bytes = _lib.row_bytes(buf)
    word = _lib.word_bytes(row_bytes, buf, out)
    _lib.launch("rk_ring_gather", buf.data_ptr(), lo.data_ptr(), n.data_ptr(),
                out.data_ptr(), lanes, cap, max_steal, row_bytes // word,
                word, device=dev)
    steal_gather.launches += 1
    return out


def steal_gather(buf_tree, lo: torch.Tensor, n: torch.Tensor, *,
                 max_steal: int):
    """Pytree of ``(L, cap, ...)`` rings -> pytree of ``(L, max_steal, ...)``
    blocks (rows ``>= n`` zeroed).  ``steal_gather.launches`` counts the
    CUDA launches."""
    return tree_map(lambda b: ring_gather(b, lo, n, max_steal), buf_tree)


steal_gather.launches = 0
