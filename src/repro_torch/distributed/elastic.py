"""Elastic shrink / grow: resize a running steal runtime's worker set
(PyTorch port of ``repro.distributed.elastic``).

The fault layer (:mod:`repro_torch.runtime.resilience`) drains a dead
lane's ring into the survivors through the ordinary superstep.  This
module turns that into fleet operations:

* :func:`evacuate` — planned eviction: kill lanes, run recovery rounds
  until their rings are empty (each round moves up to ``max_steal`` items
  per dead lane into the least loaded survivors).
* :func:`shrink` — evacuate, then rebuild the runtime over the smaller
  worker set, carrying the surviving rings, the adaptive proportion, the
  telemetry stream and the global round counter.
* :func:`grow` — the inverse: rebuild with extra empty, alive lanes.

Both work in both modes: the stacked runtime just drops or adds lanes; a
mesh runtime (:class:`~repro_torch.distributed.MeshStealRuntime`) is
rebuilt on a mesh of the first ``n`` ranks, each taking its row of the
gathered rings.  On a mesh they are collective over the whole world:
every rank calls them, a rank outside the current mesh with ``rt=None``,
and a rank outside the new mesh gets ``None`` back (it holds no
runtime).

Live resize (no rebuild): :func:`padded_runtime` builds the runtime at a
fixed lane count ``w_max`` with only ``n_active`` lanes alive (the
padding lanes are killed at round 0); :func:`live_shrink` /
:func:`live_grow` move the live count by evacuating or reviving lanes —
a host-side write to the fault schedule.  :func:`compile_count` is the
"nothing re-built, nothing re-captured" count a live resize must leave
unchanged; until the port captures CUDA graphs it only says whether the
kernel library is loaded.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from repro_torch._tree import tree_map
from repro_torch.core.ops import QueueState, to_numpy, from_numpy
from repro_torch.distributed.executor import MeshStealRuntime
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.runtime.executor import StealRuntime
from repro_torch.runtime.resilience import FaultPlan

__all__ = ["evacuate", "shrink", "grow", "padded_runtime", "live_shrink",
           "live_grow", "n_live", "compile_count"]


def evacuate(rt: StealRuntime, lanes: Sequence[int], *,
             max_rounds: Optional[int] = None) -> int:
    """Kill ``lanes`` and run recovery rounds until their rings are
    empty; returns the rounds it took.  The runtime's fault layer must be
    armed (``fault_plan=FaultPlan()`` suffices)."""
    lanes = [int(w) for w in lanes]
    if not lanes:
        return 0
    alive = rt.n_workers - int(rt.dead_lanes().sum()) - len(lanes)
    if alive < 1:
        raise ValueError("evacuating would leave no live lane to drain into")
    for w in lanes:
        rt.kill_lane(w)
    # Each round moves up to max_steal items off one dead ring, and the
    # thief's free-space clamp can slow the tail: twice the naive bound.
    if max_rounds is None:
        per_round = max(int(rt.policy.max_steal), 1)
        max_rounds = 2 * (rt.capacity * len(lanes) // per_round + 2)
    rounds = 0
    while rounds < max_rounds:
        if int(rt.sizes()[lanes].sum()) == 0:
            break
        rt.round()
        rounds += 1
    left = int(rt.sizes()[lanes].sum())
    if left:
        raise RuntimeError(
            f"evacuation of lanes {lanes} incomplete after {rounds} rounds "
            f"({left} items stranded — survivors' rings full?)")
    rt.telemetry.record_fault("evacuate", len(lanes))
    return rounds


def _host_rows(rt: StealRuntime) -> QueueState:
    """The W lanes' stacked queue state as host numpy (a gather on a
    mesh)."""
    return tree_map(to_numpy, rt.gathered_queues())


def _carried(rt: Optional[StealRuntime]) -> dict:
    """What a rebuilt runtime takes over from ``rt``.  For a mesh it comes
    from the world's rank 0 (always lane 0), so a rank that holds no
    runtime (``rt=None``) learns it too."""
    out = None if rt is None else dict(
        mesh=isinstance(rt, MeshStealRuntime), n_workers=rt.n_workers,
        capacity=rt.capacity, item_spec=tree_map(lambda s: s.cpu(),
                                                 rt.item_spec),
        policy=rt.policy, adaptive=rt.controller is not None,
        adaptive_config=rt.controller.config if rt.controller else None,
        device=(rt.mesh.requested_device
                if isinstance(rt, MeshStealRuntime) else rt.device),
        telemetry=rt.telemetry, rounds_run=rt.rounds_run,
        proportion=rt.controller.proportion if rt.controller else None,
        history=list(rt.controller.history) if rt.controller else None)
    if rt is None or out["mesh"]:
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = box[0]
    return out


def _rebuild(rt: Optional[StealRuntime], n_workers: int, carried: dict
             ) -> Optional[StealRuntime]:
    """A fresh runtime of the same kind with ``n_workers`` lanes, the same
    policy, backend, adaptive config and device, the fault layer armed
    (schedules do not carry over: lane indices just changed meaning).  A
    mesh runtime is rebuilt on the first ``n_workers`` ranks; a rank
    outside them gets None."""
    kwargs = dict(policy=carried["policy"], adaptive=carried["adaptive"],
                  adaptive_config=carried["adaptive_config"],
                  backend=carried["policy"].backend if rt is None else rt.ops,
                  fault_plan=FaultPlan())
    if not carried["mesh"]:
        if type(rt) is not StealRuntime:
            raise TypeError(f"don't know how to resize {type(rt).__name__}")
        return StealRuntime(n_workers, rt.capacity, rt.item_spec,
                            device=rt.device, **kwargs)
    if rt is not None and type(rt) is not MeshStealRuntime:
        raise TypeError(f"don't know how to resize {type(rt).__name__}")
    mesh = make_worker_mesh(n_workers, device=carried["device"])
    if not mesh.member:
        return None
    return MeshStealRuntime(mesh, carried["capacity"], carried["item_spec"],
                            **kwargs)


def _carry_over(carried: dict, new: Optional[StealRuntime], rows
                ) -> Optional[StealRuntime]:
    """``new`` with ``carried``'s telemetry, round counter and controller,
    and its own lanes' rows of ``rows`` (the W lanes' host arrays; None:
    keep its empty rings)."""
    if new is None:
        return None
    if rows is not None:
        new.queues = tree_map(lambda a: new.lanes.local(from_numpy(
            a, new.device)).contiguous(), rows)
    new.telemetry = carried["telemetry"]
    new.rounds_run = carried["rounds_run"]
    if new.controller is not None and carried["history"] is not None:
        new.controller.proportion = carried["proportion"]
        new.controller.history = list(carried["history"])
    return new


def shrink(rt: Optional[StealRuntime], drop_lanes: Sequence[int]
           ) -> Optional[StealRuntime]:
    """Evacuate ``drop_lanes`` and rebuild the runtime without them.  Lane
    ``i`` of the result is the i-th SURVIVING lane of the input; the item
    multiset is exactly preserved.  Returns the new runtime (on a mesh,
    None on the ranks past the smaller mesh)."""
    drop = sorted({int(w) for w in drop_lanes})
    if not drop:
        return rt
    rows = None
    if rt is not None:
        _check_kind(rt)
        evacuate(rt, drop)
        rows = tree_map(lambda x: np.delete(x, drop, axis=0),
                        _host_rows(rt))
    carried = _carried(rt)
    new = _carry_over(carried, _rebuild(rt, carried["n_workers"] - len(drop),
                                        carried), rows)
    if new is not None:
        new.telemetry.record_fault("shrink", len(drop))
    return new


def grow(rt: Optional[StealRuntime], n_new: int) -> Optional[StealRuntime]:
    """Rebuild with ``n_new`` extra lanes, empty and alive.  Existing
    lanes keep their rings and indices; the next rounds route work into
    the newcomers through the normal idle-thief plan.  On a mesh the new
    lanes are the next ranks of the world, which call this with
    ``rt=None``."""
    n_new = int(n_new)
    if n_new <= 0:
        return rt
    rows = None
    if rt is not None:
        _check_kind(rt)
        rows = _host_rows(rt)
    carried = _carried(rt)
    n = carried["n_workers"]
    new = _rebuild(rt, n + n_new, carried)

    def splice(old_arr):
        out = np.zeros((n + n_new,) + old_arr.shape[1:], old_arr.dtype)
        out[:n] = old_arr
        return out

    new = _carry_over(carried, new,
                      None if rows is None else tree_map(splice, rows))
    if new is not None:
        new.telemetry.record_fault("grow", n_new)
    return new


def _check_kind(rt: StealRuntime) -> None:
    if type(rt) not in (StealRuntime, MeshStealRuntime):
        raise TypeError(f"don't know how to resize {type(rt).__name__}")


# ---------------------------------------------------------------------------
# Live resize: fixed w_max, dead-masked padding lanes, nothing re-built


def padded_runtime(n_active: int, capacity: int, item_spec: Any, *,
                   w_max: int, execution: str = "vmap",
                   fault_plan: Optional[FaultPlan] = None,
                   **kwargs) -> StealRuntime:
    """A runtime of ``w_max`` lanes with ``n_active`` alive: lanes
    ``[n_active, w_max)`` are padding — killed at round 0, empty, out of
    every plan — so :func:`live_shrink` / :func:`live_grow` move the live
    count without building anything.  ``fault_plan`` schedules further
    failures on the active lanes; the padding kills are merged in.  Other
    ``kwargs`` (policy, backend, pod_size, device, mesh, ...) go to
    :func:`~repro_torch.distributed.launch.launch_runtime`, with
    ``execution`` ``"vmap"`` (the stacked lanes, the JAX package's name for
    them) or ``"mesh"`` (one lane per rank, ``w_max`` ranks)."""
    n_active, w_max = int(n_active), int(w_max)
    if not (1 <= n_active <= w_max):
        raise ValueError(
            f"n_active={n_active} must be in [1, w_max={w_max}]")
    base = fault_plan or FaultPlan()
    for w, _ in base.kills:
        if w >= n_active:
            raise ValueError(
                f"fault_plan kills lane {w}, which is a padding lane "
                f"(>= n_active={n_active})")
    pad_kills = tuple((w, 0) for w in range(n_active, w_max))
    plan = FaultPlan(kills=base.kills + pad_kills, delays=base.delays,
                     drops=base.drops)
    from repro_torch.distributed.launch import launch_runtime

    rt = launch_runtime(w_max, capacity, item_spec, execution=execution,
                        fault_plan=plan, **kwargs)
    rt.telemetry.record_fault("padded_launch", w_max - n_active)
    return rt


def n_live(rt: StealRuntime) -> int:
    """Live lanes as of the next round (W minus the dead mask)."""
    return rt.n_workers - int(rt.dead_lanes().sum())


def live_shrink(rt: StealRuntime, drop_lanes: Sequence[int]) -> int:
    """Shrink IN PLACE: evacuate ``drop_lanes`` into the survivors and
    leave them dead-masked (they become padding).  Returns the recovery
    rounds the evacuation took."""
    rounds = evacuate(rt, drop_lanes)
    rt.telemetry.record_fault("shrink_live", len(list(drop_lanes)))
    return rounds


def live_grow(rt: StealRuntime, n_new: int) -> List[int]:
    """Grow IN PLACE: revive ``n_new`` dead (padding) lanes, empty and
    alive, lowest index first; raises when fewer exist (the ``w_max``
    headroom is spent — a bigger fleet needs :func:`grow`).  Returns the
    lanes revived."""
    n_new = int(n_new)
    if n_new <= 0:
        return []
    dead = np.flatnonzero(rt.dead_lanes())
    if len(dead) < n_new:
        raise ValueError(
            f"live_grow({n_new}) needs {n_new} dead lanes but only "
            f"{len(dead)} exist — w_max headroom exhausted; use grow()")
    lanes = [int(w) for w in dead[:n_new]]
    for w in lanes:
        rt.revive_lane(w)
    rt.telemetry.record_fault("grow_live", n_new)
    return lanes


def compile_count(rt: StealRuntime) -> int:
    """Builds of the kernel library plus CUDA-graph captures — what a
    live resize must leave unchanged.  The port loads its kernel library
    once per process and captures no graph yet (its rounds launch from
    Python), so this is 1 once a kernel has launched and 0 before, and a
    live resize cannot change it: the check is vacuous until the port
    captures graphs.  ``rt`` is taken for the JAX package's signature."""
    del rt
    from repro_torch.kernels import _lib

    return int(_lib._LIB is not None)
