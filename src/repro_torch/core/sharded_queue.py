"""Stacked per-worker queues (PyTorch port of ``repro.core.sharded_queue``).

The JAX package stacks W queues along a leading axis and maps the
superstep over it with ``vmap`` (one device) or ``shard_map`` (one lane
per device).  The port builds the lanes a process holds: all W stacked on
one device for the stacked runtime, ``(1, cap, ...)`` for the one lane of
a mesh rank (:class:`repro_torch.distributed.MeshStealRuntime`); the
superstep works on that stack (see :mod:`repro_torch.core.master`).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.core.ops import QueueState

__all__ = ["make_sharded_queues"]


def make_sharded_queues(n_workers: int, capacity: int, item_spec: Any, *,
                        device=None) -> QueueState:
    """``n_workers`` empty queues stacked on a leading worker axis: leaves
    ``(n_workers, capacity, ...)``, int32 ``(n_workers,)`` cursors — every
    lane of a stacked runtime, or ``n_workers=1`` for a mesh rank's own
    lane.  ``device=None`` means CUDA, and raises without it."""
    dev = resolve_device(device)
    buf = tree_map(
        lambda s: torch.zeros((n_workers, capacity) + tuple(s.shape),
                              dtype=s.dtype, device=dev),
        item_spec)
    return QueueState(buf=buf,
                      lo=torch.zeros((n_workers,), dtype=torch.int32,
                                     device=dev),
                      size=torch.zeros((n_workers,), dtype=torch.int32,
                                       device=dev))
