"""One queue lane per process over ``torch.distributed`` (PyTorch port of
``repro.distributed.executor``).

:class:`MeshStealRuntime` is :class:`repro_torch.runtime.StealRuntime`
with its lane collectives taken from a worker mesh
(:func:`repro_torch.launch.mesh.make_worker_mesh`): each rank owns one
lane, its ring ``(1, cap, ...)`` on the rank's device from the first byte,
as each JAX device owns one lane under ``shard_map``.  The round itself is
the stacked runtime's, not a copy of it: the superstep's size gather,
window gather (compact) or block all-to-all (dense), the worker body's
lane max, the drain signal and the adaptive update's size vector each pass
through :class:`repro_torch.core.lanes.MeshLanes`, which turns them into
collectives over the mesh, or over this lane's pod and row in a two-level
round.

SPMD contract:

* every rank runs the same program and makes every call that
  carries a collective in the same order — construction, ``push``,
  ``round``, ``run_fused``, ``run``, ``sizes``, ``total_size``, ``drain``,
  ``save_state``, ``restore_state``, and the elastic resizes;
* each rank owns one lane on its device (``cuda:{local rank %
  device_count}`` by default, the CPU when the mesh was built with
  ``device="cpu"``);
* the plan, the counters, the proportion, the adaptive controller, the
  fault schedule and the telemetry are computed identically on every
  rank — the JAX package's replicated virtual master — and the stats a
  round returns are the stacked runtime's ``(W,)`` layout on every rank
  (one gather of the block's per-lane records,
  :func:`repro_torch.core.lanes.stack_stats`).

With the same seeds and policy the queues, stats, telemetry and
proportion history are bit-equal to the stacked runtime's.  Under
``nccl`` no host read happens inside a round; ``gloo`` stages each
collective on a CUDA tensor through the host, which syncs it every time.
"""

from __future__ import annotations

from repro_torch.launch.mesh import WorkerMesh
from repro_torch.runtime.executor import StealRuntime

__all__ = ["MeshStealRuntime"]


class MeshStealRuntime(StealRuntime):
    """Drives adaptive rebalancing rounds with one queue lane per rank.

    Args:
      mesh: a :class:`~repro_torch.launch.mesh.WorkerMesh`, flat (flat
        supersteps over all its lanes) or in pods (hierarchical
        supersteps; ``pod_size`` is the mesh's).  This rank must be one of
        its lanes.
      capacity / item_spec / policy / adaptive / adaptive_config /
      backend / fault_plan: exactly as
      :class:`~repro_torch.runtime.StealRuntime`.
    """

    def __init__(self, mesh: WorkerMesh, capacity: int, item_spec, **kwargs):
        for key in ("axis_name", "pod_axis", "pod_size", "n_workers",
                    "device", "lanes"):
            if key in kwargs:
                raise TypeError(
                    f"MeshStealRuntime derives {key!r} from the mesh; "
                    f"don't pass it")
        lanes = mesh.lanes()  # raises on a rank outside the mesh
        self.mesh = mesh
        super().__init__(mesh.n_workers, capacity, item_spec,
                         pod_size=mesh.pod_size, device=mesh.device,
                         lanes=lanes, **kwargs)
