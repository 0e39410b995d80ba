"""Plain PyTorch version of K4 ``ring_transfer`` (index arithmetic plus
``torch.where``): the CPU path of :func:`..ops.transfer_splice` and what
``chip_smoke.py`` holds the CUDA kernel against.  Returns a new tensor;
the wrapper writes it in place."""

from __future__ import annotations

import torch

__all__ = ["ring_transfer_ref"]


def ring_transfer_ref(buf: torch.Tensor, gathered: torch.Tensor,
                      head: torch.Tensor, src_start: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
    """``buf`` ``(L, cap, ...)`` with rows ``(head[l] + i) % cap`` replaced
    by ``gathered[src_start[l] + i]`` for ``i < n[l]`` (``gathered`` is
    ``(S, ...)``, shared by all lanes; a source row past ``S`` reads row
    ``S - 1``, a negative one counts from the end of the stack, and one
    before the stack raises ``IndexError`` where it is spliced).  ``n``
    must be pre-clamped to ``min(span, cap)``."""
    cap = buf.shape[1]
    srows = gathered.shape[0]
    off = (torch.arange(cap, dtype=torch.int64, device=buf.device)
           - head.to(torch.int64)[:, None]) % cap
    live = off < n.to(torch.int64)[:, None]
    rows = (src_start.to(torch.int64)[:, None] + off).clamp(max=srows - 1)
    vals = gathered[torch.where(live, rows, 0)]  # read only what is spliced
    return torch.where(live.reshape(tuple(live.shape)
                                    + (1,) * (buf.dim() - 2)), vals, buf)
