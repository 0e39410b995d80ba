"""Stacked per-worker queues and the superstep on them, two ways (PyTorch port
of ``repro.core.sharded_queue``).

The JAX package stacks W queues along a leading axis and maps the
superstep over it with ``vmap`` (one device) or ``shard_map`` (one lane
per device).  The port builds the lanes a process holds: all W stacked on
one device for the stacked runtime, ``(1, cap, ...)`` for the one lane of
a mesh rank (:class:`repro_torch.distributed.MeshStealRuntime`); the
superstep works on that stack (see :mod:`repro_torch.core.master`).

* :func:`vmapped_superstep` — the superstep on the W stacked lanes of one
  device (:class:`~repro_torch.core.lanes.StackedLanes`);
* :func:`sharded_superstep` — the superstep with one lane per rank of a
  :class:`~repro_torch.launch.mesh.WorkerMesh`
  (:class:`~repro_torch.core.lanes.MeshLanes`), flat or two-level over
  its pods.

Both return the stats of the JAX package's function of the same name:
:class:`~repro_torch.core.master.RebalanceStats` in its layout, from the
stacked layout the port's superstep keeps.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.core import master as master_ops
from repro_torch.core import ops as q_ops
from repro_torch.core.lanes import StackedLanes, stack_stats
from repro_torch.core.ops import QueueState
from repro_torch.core.policy import StealPolicy

__all__ = ["make_sharded_queues", "vmapped_superstep", "sharded_superstep"]


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


def _on(qs: QueueState, device: torch.device, what: str) -> None:
    at = qs.size.device
    if at.type != device.type or device.index not in (None, at.index):
        raise ValueError(f"{what} was made for {device}; the queues lie on "
                         f"{qs.size.device}")


def vmapped_superstep(policy: StealPolicy,
                      ops: Optional[q_ops.BulkOps] = None, *,
                      device=None) -> Callable:
    """The superstep on W lanes stacked on one device:
    ``qs -> (qs, stats)``, ``qs`` the ``(W, cap, ...)`` stack of
    :func:`make_sharded_queues` on ``device`` (None: CUDA, which raises
    without it).  ``ops`` pins the backend (default: ``policy.backend``).
    The input stack is left as it was.

    The stats are laid out as the JAX function's: every field with a
    leading ``(W,)`` lane axis holding each lane's copy of the replicated
    value (sizes ``(W, W)``, counters ``(W,)``)."""
    dev = resolve_device(device)
    if ops is None:
        ops = q_ops.make_ops(policy.backend)

    def step(qs: QueueState):
        _on(qs, dev, "this superstep")
        w = qs.size.shape[0]
        qs, stats = master_ops.superstep(qs, policy, ops=ops,
                                         lanes=StackedLanes(w))
        return qs, master_ops.RebalanceStats(*(
            f.expand((w,) + tuple(f.shape)).contiguous() for f in stats))

    return step


def sharded_superstep(mesh, policy: StealPolicy, worker_axis: str = "workers",
                      pod_axis: Optional[str] = None,
                      ops: Optional[q_ops.BulkOps] = None) -> Callable:
    """The superstep with one lane per rank of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.WorkerMesh`): ``qs -> (qs, stats)``,
    ``qs`` this rank's lane ``(1, cap, ...)`` on the mesh's device, every
    rank of the mesh calling the step in the same order.  Flat over the
    ``worker_axis`` (on a mesh in pods: within each pod), or two-level over
    the pods with ``pod_axis`` (:func:`~repro_torch.core.master.
    hierarchical_superstep`).  ``ops`` pins the backend (default:
    ``policy.backend``).  The input lane is left as it was.

    The stats are laid out as the JAX function's, the same on every rank:
    the stats of lane 0 (pod 0, worker 0), replicated leaves once and
    counters ``(1,)`` — flat, the size vectors of the lanes the superstep
    spans and the plan's counters; in pods, pod 0's sizes before the
    round, lane 0 of each pod's sizes after it, pod 0's intra-pod counters
    and the cross-pod ones."""
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside the "
                         f"{mesh.n_workers}-lane mesh")
    if worker_axis != mesh.axis_names[-1]:
        raise ValueError(f"the mesh's worker axis is "
                         f"{mesh.axis_names[-1]!r}, not {worker_axis!r}")
    if pod_axis is not None and (mesh.pod_size is None
                                 or pod_axis != mesh.axis_names[0]):
        raise ValueError(f"the mesh {dict(zip(mesh.axis_names, mesh.shape))}"
                         f" has no pod axis {pod_axis!r}")
    if ops is None:
        ops = q_ops.make_ops(policy.backend)
    lanes = mesh.lanes()
    flat_lanes = lanes if mesh.pod_size is None else mesh.lanes("pods")
    group = mesh.shape[-1]          # the lanes one flat superstep spans

    def step(qs: QueueState):
        _on(qs, mesh.device, "this mesh's superstep")
        if pod_axis is None:
            qs, stats = master_ops.superstep(qs, policy, ops=ops,
                                             lanes=flat_lanes)
            full = stack_stats(lanes, [stats], pod_size=None)[0]
            view = full._replace(sizes_before=full.sizes_before[:group],
                                 sizes_after=full.sizes_after[:group])
        else:
            qs, stats = master_ops.hierarchical_superstep(
                qs, policy, pod_size=mesh.pod_size, ops=ops, lanes=lanes)
            full = stack_stats(lanes, [stats], pod_size=mesh.pod_size)[0]
            view = full._replace(
                sizes_before=full.sizes_before[:group],
                sizes_after=full.sizes_after[::group],
                n_transferred=full.n_transferred[0],
                n_steals=full.n_steals[0], bytes_moved=full.bytes_moved[0])
        return qs, master_ops.RebalanceStats(*(
            f.reshape(-1) if f.dim() else f.reshape(1) for f in view))

    return step
