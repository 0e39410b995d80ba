"""Wrapper of K1 ``ring_gather`` for payload pytrees on stacked lanes.

Every ``(L, cap, ...)`` leaf of a CUDA payload tree is moved by one launch
of the CUDA kernel (``ring_gather.cu``), up to ``_lib.MAX_LEAVES`` leaves
per launch; a CPU leaf is moved by the plain version
(``ref.ring_gather_ref``).  There is no other route: a CUDA tensor the
kernel refuses raises.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_map
from repro_torch.kernels import _lib
from repro_torch.kernels.queue_steal.ref import ring_gather_ref

__all__ = ["steal_gather", "ring_gather"]


def steal_gather(buf_tree, lo: torch.Tensor, n: torch.Tensor, *,
                 max_steal: int):
    """Pytree of ``(L, cap, ...)`` rings -> pytree of ``(L, max_steal, ...)``
    blocks, rows ``(lo + i) % cap`` for ``i < n``, zero after.
    ``steal_gather.launches`` counts the CUDA launches (one per
    ``_lib.MAX_LEAVES`` leaves)."""
    pairs = []

    def one(buf):
        if buf.device.type == "cpu":
            return ring_gather_ref(buf, lo, n, max_steal)
        out = torch.empty((buf.shape[0], max_steal) + tuple(buf.shape[2:]),
                          dtype=buf.dtype, device=buf.device)
        pairs.append((buf, out))
        return out

    outs = tree_map(one, buf_tree)
    if pairs:
        _launch(pairs, lo, n, max_steal)
    return outs


def _launch(pairs, lo, n, max_steal: int) -> None:
    lanes, cap = pairs[0][0].shape[:2]
    if any(buf.shape[:2] != (lanes, cap) for buf, _ in pairs):
        raise ValueError("every leaf must be (lanes, cap, ...) alike")
    lo = _lib.lane_vec(lo, lanes, "lo")
    n = _lib.lane_vec(n, lanes, "n")
    dev = _lib.check_cuda(lo, n, *(t for pair in pairs for t in pair))
    if lanes == 0 or max_steal == 0:
        return
    if cap == 0:
        raise ValueError("cannot gather from rings of 0 rows")
    for tree in _lib.ring_trees(pairs, max(cap, max_steal)):
        _lib.launch("rk_ring_gather", tree, lo.data_ptr(), n.data_ptr(),
                    lanes, cap, max_steal, device=dev, counter=steal_gather)


def ring_gather(buf: torch.Tensor, lo: torch.Tensor, n: torch.Tensor,
                max_steal: int) -> torch.Tensor:
    """One leaf: ``(L, cap, ...)`` -> ``(L, max_steal, ...)``."""
    return steal_gather(buf, lo, n, max_steal=max_steal)


steal_gather.launches = 0
