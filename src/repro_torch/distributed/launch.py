"""One entry point for "give me an executor": stacked lanes or a mesh
(PyTorch port of ``repro.distributed.launch``).

``launch_runtime`` is how consumers (the DD solver's ``parallel_solve``,
the elastic resizes) pick the execution mode without knowing either
runtime class: ``execution="vmap"`` builds the W lanes stacked on one
device (:class:`repro_torch.runtime.StealRuntime`, the counterpart of the
JAX package's vmapped lanes), ``execution="mesh"`` one lane per rank
(:class:`~repro_torch.distributed.executor.MeshStealRuntime`) on a worker
mesh from :func:`repro_torch.launch.mesh.make_worker_mesh`, or a mesh
passed in.  Both return the same surface — ``push`` / ``round`` /
``run_fused`` / ``run`` / ``telemetry`` — so driving code is
mode-agnostic; worker bodies use ``runtime.lanes`` for their lane-axis
collectives.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.distributed.executor import MeshStealRuntime
from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh
from repro_torch.runtime.executor import StealRuntime

__all__ = ["launch_runtime", "EXECUTIONS"]

EXECUTIONS = ("vmap", "mesh")


def launch_runtime(n_workers: int, capacity: int, item_spec, *,
                   execution: str = "mesh",
                   mesh: Optional[WorkerMesh] = None,
                   pod_size: Optional[int] = None,
                   device=None, **kwargs) -> StealRuntime:
    """Construct the executor for ``execution`` in ``("vmap", "mesh")``.

    ``pod_size`` selects hierarchical supersteps in either mode.  With
    ``execution="mesh"`` every rank of the world calls this (building the
    mesh is collective over the world); ``mesh`` optionally pins the mesh
    instead of building one over the first ``n_workers`` ranks, and must
    agree with ``n_workers`` and ``pod_size``.  ``device`` is the stacked
    lanes' device, or the mesh's (``None``: each rank's CUDA device).
    Remaining keywords (``policy`` / ``adaptive`` / ``adaptive_config`` /
    ``backend`` / ``fault_plan``) pass through to the runtime unchanged.
    """
    if execution == "vmap":
        if mesh is not None:
            raise ValueError("execution='vmap' takes no mesh")
        return StealRuntime(n_workers, capacity, item_spec,
                            pod_size=pod_size, device=device, **kwargs)
    if execution != "mesh":
        raise ValueError(
            f"unknown execution {execution!r}; expected one of {EXECUTIONS}")
    if mesh is None:
        mesh = make_worker_mesh(n_workers, pod_size=pod_size, device=device)
    else:
        if mesh.n_workers != n_workers:
            raise ValueError(
                f"mesh has {mesh.n_workers} ranks but n_workers={n_workers}")
        # A pinned mesh must agree with the requested hierarchy — a flat
        # mesh with pod_size (or the reverse) would silently run the
        # OTHER superstep mode.
        if pod_size != mesh.pod_size:
            raise ValueError(
                f"mesh implies pod_size={mesh.pod_size} (axes "
                f"{mesh.axis_names}) but pod_size={pod_size} was requested")
        if device is not None:
            raise ValueError("a pinned mesh fixes each lane's device; "
                             "pass no device")
    return MeshStealRuntime(mesh, capacity, item_spec, **kwargs)
