"""One queue lane per process, and resizing the worker set (PyTorch port
of ``repro.distributed``).

The stacked :class:`repro_torch.runtime.StealRuntime` holds W worker
lanes on one device; this package runs the SAME round with one lane per
rank of a ``torch.distributed`` process group, the paper's deployment
shape: each worker owns its queue, the virtual master is replicated, and
at most one stealer touches a victim per round.

  executor  :class:`MeshStealRuntime` — the stacked runtime's round with
            its lane collectives (size and window gathers, the block
            all-to-all, the lane max, the drain signal) over the mesh
  launch    :func:`launch_runtime` — ``execution="vmap" | "mesh"`` in one
            factory, on :func:`repro_torch.launch.mesh.make_worker_mesh`
  elastic   :func:`evacuate` / :func:`shrink` / :func:`grow` and the live
            resize of a padded runtime, in both modes — dead rings drain
            through the ordinary exchange at proportion 1.0 before lanes
            go
  serve     :class:`RuntimeAdmissionMaster` / :class:`DeviceReplicaLane` —
            the serving master's admission queues as executor lanes, in
            both modes (``ServeCluster(execution=...)`` and the decode
            engine's device master)

Parity contract: for identical seeds and policies the mesh runtime's
queues, stats, telemetry and proportion history are bit-equal to the
stacked runtime's (``tests/test_torch_distributed.py``, on 8 ``gloo``
CPU ranks).
"""

from repro_torch.distributed.elastic import evacuate, grow, shrink
from repro_torch.distributed.executor import MeshStealRuntime
from repro_torch.distributed.launch import launch_runtime
from repro_torch.distributed.serve import (DeviceReplicaLane,
                                           RuntimeAdmissionMaster)

__all__ = ["MeshStealRuntime", "launch_runtime", "evacuate", "grow",
           "shrink", "RuntimeAdmissionMaster", "DeviceReplicaLane"]
