"""Plain PyTorch version of K1 ``ring_gather`` (index arithmetic plus
``torch.where``): the CPU path of :func:`..ops.steal_gather`, the
reference backend's steal gather, and what ``chip_smoke.py`` holds the
CUDA kernel against."""

from __future__ import annotations

import torch

__all__ = ["ring_gather_ref"]


def ring_gather_ref(buf: torch.Tensor, lo: torch.Tensor, n: torch.Tensor,
                    max_steal: int) -> torch.Tensor:
    """``buf`` ``(L, cap, ...)``, ``lo`` / ``n`` int32 ``(L,)`` ->
    ``(L, max_steal, ...)`` with row ``i`` of lane ``l`` equal to
    ``buf[l, (lo[l] + i) % cap]`` for ``i < n[l]`` and zero after."""
    lanes, cap = buf.shape[:2]
    offs = torch.arange(max_steal, dtype=torch.int64, device=buf.device)
    phys = (lo.to(torch.int64)[:, None] + offs) % cap
    lane = torch.arange(lanes, device=buf.device)[:, None]
    out = buf[lane, phys]
    live = (offs < n.to(torch.int64)[:, None]).reshape(
        (lanes, max_steal) + (1,) * (buf.dim() - 2))
    return torch.where(live, out, torch.zeros((), dtype=buf.dtype,
                                              device=buf.device))
