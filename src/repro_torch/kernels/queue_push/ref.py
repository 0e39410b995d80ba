"""Plain PyTorch versions of K2 ``ring_scatter`` and K3 ``ring_slice``
(index arithmetic plus ``torch.where``): the CPU path of the wrappers in
:mod:`.ops`, the reference backend's push and bulk pop, and what
``chip_smoke.py`` holds the CUDA kernels against.  Both return new
tensors; the wrappers write K2's result in place."""

from __future__ import annotations

import torch

__all__ = ["ring_scatter_ref", "ring_slice_ref"]


def _rows_mask(live: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return live.reshape(tuple(live.shape) + (1,) * (like.dim() - 2))


def ring_scatter_ref(buf: torch.Tensor, batch: torch.Tensor,
                     start: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``buf`` ``(L, cap, ...)`` with rows ``(start[l] + i) % cap`` replaced
    by ``batch[l, i]`` for ``i < n[l]``; ``n`` must be pre-clamped to
    ``min(batch rows, cap)``.  A read-modify-write over the whole ring
    (one gather and a select), as the JAX package's oracle is."""
    lanes, cap = buf.shape[:2]
    bsz = batch.shape[1]
    off = (torch.arange(cap, dtype=torch.int64, device=buf.device)
           - start.to(torch.int64)[:, None]) % cap
    live = off < n.to(torch.int64)[:, None]
    lane = torch.arange(lanes, device=buf.device)[:, None]
    vals = batch[lane, off.clamp(max=max(bsz - 1, 0))]
    return torch.where(_rows_mask(live, buf), vals, buf)


def ring_slice_ref(buf: torch.Tensor, lo: torch.Tensor, size: torch.Tensor,
                   n: torch.Tensor, max_n: int) -> torch.Tensor:
    """``(L, max_n, ...)``: rows ``(lo + size - n + i) % cap`` for
    ``i < n`` (the newest ``n``, oldest first), zero after; ``n`` must be
    pre-clamped to ``size``."""
    lanes, cap = buf.shape[:2]
    start = (lo.to(torch.int64) + size.to(torch.int64) - n.to(torch.int64))
    offs = torch.arange(max_n, dtype=torch.int64, device=buf.device)
    phys = (start[:, None] + offs) % cap
    lane = torch.arange(lanes, device=buf.device)[:, None]
    out = buf[lane, phys]
    live = offs < n.to(torch.int64)[:, None]
    return torch.where(_rows_mask(live, out), out,
                       torch.zeros((), dtype=buf.dtype, device=buf.device))
