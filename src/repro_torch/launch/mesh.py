"""Worker and model meshes over ``torch.distributed`` (port of
``repro.launch.mesh``) and a launcher of ranks.

The JAX package's worker mesh is a ``jax.sharding.Mesh`` of devices with
one axis (flat) or two (``(pods, workers)``).  Here a lane is a process:
:func:`make_worker_mesh` takes the first ``n_workers`` ranks of the
initialised default process group, gives each its lane and its device,
and, in pods, the groups that stand for the two mesh axes — one group
per pod, and one per row that crosses the pods (lane ``l`` of every
pod).  :func:`run_workers` spawns ranks, joins them into a group and runs
a function on each (the tests and ``chip_smoke.py`` use it).

:class:`ModelMesh` is the model mesh: the first ``prod(shape)`` ranks in
a ``(data, model)`` or ``(pod, data, model)`` grid, row-major as
``jax.make_mesh`` lays out devices.  It gives each rank its coordinate on
every axis and one process group per axis line (the ranks that differ
only in that axis).  Its collectives, ``all_reduce`` (SUM / MAX) and
``all_gather`` over one axis, go through a ``core.lanes.MeshLanes`` per
axis line, the seam the queue lanes use (``torch.distributed``, staged
through the host under ``gloo``).  ``with mesh:`` makes
it the active model mesh (``models.layers._active_mesh``), under which
flash-decoding and expert-parallel MoE take their collective branches.
``shard`` and ``gather`` turn a full tree into this rank's block of it by
a tree of specs, and back: what ``shard_map``'s ``in_specs`` and
``out_specs`` do in JAX.  :func:`make_model_mesh` builds one
(``jax.make_mesh``'s counterpart); :func:`make_production_mesh` the JAX
package's ``(16, 16)`` and ``(2, 16, 16)`` meshes.

The collectives are differentiable (``core.lanes``): the sharded train
step takes its gradients through them.  ``record()`` starts a log of
every collective the mesh's lanes run.  :func:`make_recording_mesh` is a
mesh of one rank's coordinates on ``core.lanes.RecordedLanes``, with no
process group: the dry run traces rank 0's step through it on ``meta``
tensors, and its log is what that rank's ``MeshLanes`` would record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import resolve_device, tree_map
from repro_torch.core.lanes import MeshLanes, RecordedLanes
from repro_torch.models import layers

__all__ = ["WorkerMesh", "make_worker_mesh", "ModelMesh", "make_model_mesh",
           "make_recording_mesh", "make_production_mesh",
           "production_mesh_shape", "run_workers", "CHIPS_PER_POD"]

# Devices in one pod of the production mesh, laid out (data 16, model 16):
# a mesh topology, not a figure of any one chip.
CHIPS_PER_POD = 256


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """The first ``n_workers`` ranks of the world as queue lanes: rank
    ``i`` holds lane ``i`` on ``device``.  ``shape`` and ``axis_names``
    are the JAX mesh's (``(W,)`` / ``(workers,)`` flat, ``(P, L)`` /
    ``(pods, workers)`` in pods of ``pod_size``).  On a rank outside the
    mesh ``lane`` and ``device`` are None and the groups are unusable."""

    n_workers: int
    pod_size: Optional[int]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    lane: Optional[int]
    device: Optional[torch.device]
    requested_device: Any
    group: Any
    pod_group: Any = None
    row_group: Any = None

    @property
    def member(self) -> bool:
        return self.lane is not None

    def lanes(self, level: Optional[str] = None) -> MeshLanes:
        """The lane collectives over the mesh (``level=None``), this
        rank's pod (``"pods"``) or its row across the pods (``"rows"``)."""
        if not self.member:
            raise ValueError(
                f"rank {self.rank} is outside the {self.n_workers}-lane mesh")
        writer = self.lane == 0
        if level is None:
            return MeshLanes(self.group, self.n_workers, self.lane,
                             writer=writer, levels=self._level)
        if self.pod_size is None:
            raise ValueError("a flat mesh has no pod levels")
        if level == "pods":
            return MeshLanes(self.pod_group, self.pod_size,
                             self.lane % self.pod_size, writer=writer)
        if level == "rows":
            return MeshLanes(self.row_group, self.shape[0],
                             self.lane // self.pod_size, writer=writer)
        raise ValueError(f"unknown level {level!r}; expected 'pods' or "
                         f"'rows'")

    def _level(self, pod_size: int, across: bool) -> MeshLanes:
        if pod_size != self.pod_size:
            raise ValueError(f"the mesh's pods hold {self.pod_size} lanes, "
                             f"not {pod_size}")
        return self.lanes("rows" if across else "pods")


def _lane_device(device) -> torch.device:
    """``device`` as given, or ``cuda:{local rank % device_count}``;
    raises where there is no CUDA and none was asked for."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_worker_mesh(n_workers: int, *, pod_size: Optional[int] = None,
                     axis_name: str = "workers", pod_axis: str = "pods",
                     device=None) -> WorkerMesh:
    """A queue-worker mesh over the first ``n_workers`` ranks of the
    initialised default process group: flat, or ``n_workers // pod_size``
    pods of ``pod_size`` when ``pod_size`` is set.  Every rank of the world
    must call it (creating a group is collective over the world), in the
    same order as the other ranks' calls.  ``device=None`` puts rank ``r``'s
    lane on ``cuda:{local rank % device_count}`` (``LOCAL_RANK``, else the
    rank), and raises without CUDA; ``device="cpu"`` asks for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_worker_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or run_workers)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n_workers:
        raise ValueError(
            f"make_worker_mesh(n_workers={n_workers}) needs at least that "
            f"many ranks; the world has {world} (ranks 0-{world - 1})")
    if pod_size is not None and n_workers % pod_size != 0:
        raise ValueError(
            f"n_workers={n_workers} not divisible by pod_size={pod_size}")
    ranks = list(range(n_workers))
    group = dist.group.WORLD if n_workers == world else dist.new_group(ranks)
    pod_group = row_group = None
    if pod_size is None:
        shape, axes = (n_workers,), (axis_name,)
    else:
        n_pods = n_workers // pod_size
        shape, axes = (n_pods, pod_size), (pod_axis, axis_name)
        for p in range(n_pods):
            g = dist.new_group(ranks[p * pod_size:(p + 1) * pod_size])
            if rank // pod_size == p:
                pod_group = g
        for lane in range(pod_size):
            g = dist.new_group(ranks[lane::pod_size])
            if rank % pod_size == lane:
                row_group = g
    member = rank < n_workers
    dev = _lane_device(device) if member else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    return WorkerMesh(
        n_workers=n_workers, pod_size=pod_size, shape=shape, axis_names=axes,
        rank=rank, lane=rank if member else None, device=dev,
        requested_device=device, group=group if member else None,
        pod_group=pod_group if member else None,
        row_group=row_group if member else None)


# ---------------------------------------------------------------------------
# The model mesh


class ModelMesh:
    """This rank's place in a model mesh of ``prod(shape)`` ranks, and the
    collectives over its axes.  ``shape`` maps each axis name to its size
    (as a JAX mesh's ``shape`` does), ``coords`` this rank's coordinate on
    each axis.  ``lanes[axis]`` is this rank's line along ``axis`` as
    ``core.lanes.MeshLanes`` (lane ``i`` the rank at coordinate ``i``),
    through which every collective of the model goes.  On a rank outside
    the mesh ``member`` is false and nothing but the constructor's group
    creation may be called."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 rank: int, groups: Optional[dict], device, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.rank = rank
        self.member = rank < int(np.prod(shape))
        self.coords = ({a: int(c) for a, c in zip(
            self.axis_names, np.unravel_index(rank, shape))}
            if self.member else {})
        if not self.member:
            self.lanes = {}
        elif groups is None:        # a recording mesh: no process group
            self.lanes = {a: RecordedLanes(self.shape[a], self.coords[a],
                                           axis=a)
                          for a in self.axis_names}
        else:
            self.lanes = {a: MeshLanes(groups[a], self.shape[a],
                                       self.coords[a],
                                       writer=self.coords[a] == 0, axis=a)
                          for a in self.axis_names}
        self.recording = groups is None
        self.group = group          # every rank of the mesh
        self.device = device
        self.log: Optional[list] = None
        # whether a batch's leading dim is split over the plan's batch
        # axes (the dry run clears it for a batch under 16, which
        # ``models.zoo.input_specs`` replicates)
        self.batch_sharded = True
        self.spmd_active = False

    def record(self) -> list:
        """Start a fresh log of every collective on every axis (the
        lanes' records, in the order they ran); returns it."""
        self.log = []
        for lanes in self.lanes.values():
            lanes.log = self.log
        return self.log

    # -- the active mesh

    def __enter__(self) -> "ModelMesh":
        layers._MESHES.append(self)
        return self

    def __exit__(self, *exc) -> None:
        layers._MESHES.remove(self)

    @contextlib.contextmanager
    def spmd(self):
        """This mesh active, and the models explicitly SPMD under it:
        every parameter, cache and batch tensor a model function is given
        is this rank's block by its spec (``param_specs``,
        ``cache_specs``, ``zoo.input_specs``), and the functions insert
        the collectives GSPMD would (``models.layers``).  Under a plain
        ``with mesh:`` only the explicit-collective bodies take their
        branches, on whole parameters."""
        prev = self.spmd_active
        self.spmd_active = True
        try:
            with self:
                yield self
        finally:
            self.spmd_active = prev

    # -- axes

    def _axes(self, entry) -> Tuple[str, ...]:
        """A spec entry's axes that this mesh has (the JAX package drops
        the others, so one spec serves the single- and multi-pod meshes)."""
        if entry is None:
            return ()
        names = entry if isinstance(entry, tuple) else (entry,)
        return tuple(a for a in names if a in self.shape)

    def size(self, entry) -> int:
        """The number of blocks a spec entry splits a dimension into."""
        return int(np.prod([self.shape[a] for a in self._axes(entry)],
                           dtype=np.int64))

    def index(self, entry) -> int:
        """This rank's block along a spec entry (``lax.axis_index``):
        mixed radix over the entry's axes, the first the major."""
        i = 0
        for a in self._axes(entry):
            i = i * self.shape[a] + self.coords[a]
        return i

    # -- collectives (through core.lanes.MeshLanes, the one seam)

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """``x`` reduced (``"sum"`` or ``"max"``) over the ranks of this
        rank's line along ``axis`` (``lax.psum`` / ``lax.pmax``); a
        half-precision tensor is reduced in float32 and cast back.  The
        sum's gradient passes through (the ranks use the sum alike: a
        row-parallel output); the max has none."""
        if self.shape.get(axis, 1) == 1:
            return x
        lanes = self.lanes[axis]
        reduce = {"sum": lanes.sum, "max": lanes.max}[op]
        wide = x.float() if x.dtype in (torch.bfloat16,
                                        torch.float16) else x
        return reduce(wide).to(x.dtype)

    def copy(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x``, whose gradient is summed over ``axis`` (the ranks use a
        value they all hold for different parts: a column-parallel
        input)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return self.lanes[axis].copy(x)

    def all_gather(self, x: torch.Tensor, axis: str, dim: int
                   ) -> torch.Tensor:
        """The blocks ``x`` of the ranks along ``axis``, concatenated on
        ``dim`` in coordinate order; the gradient is reduce-scattered
        back (summed over the ranks, each keeping its block)."""
        if self.shape.get(axis, 1) == 1:
            return x
        out = self.lanes[axis].all_gather(x.movedim(dim, 0))
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int
                       ) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, this rank's
        block of it on ``dim``; the gradient is all-gathered back."""
        if self.shape.get(axis, 1) == 1:
            return x
        out = self.lanes[axis].reduce_scatter(x.movedim(dim, 0))
        return out.movedim(0, dim)

    def gather_entry(self, x: torch.Tensor, entry, dim: int
                     ) -> torch.Tensor:
        """:meth:`all_gather` over every axis of a spec entry, the minor
        first (the block index is mixed radix, the first axis major)."""
        for a in reversed(self._axes(entry)):
            x = self.all_gather(x, a, dim)
        return x

    def sum_entry(self, x: torch.Tensor, entry) -> torch.Tensor:
        """:meth:`all_reduce` sums over every axis of a spec entry."""
        for a in self._axes(entry):
            x = self.all_reduce(x, a, "sum")
        return x

    def block_shape(self, shape, spec) -> Tuple[int, ...]:
        """This rank's block of a ``shape`` laid out by ``spec``: each
        named dimension cut into ``size(entry)`` blocks of
        ``ceil(n / size)`` (a dimension that does not split is padded,
        as GSPMD pads it)."""
        out = list(shape)
        for d, entry in enumerate(spec or ()):
            k = self.size(entry)
            out[d] = -(-out[d] // k)
        return tuple(out)

    # -- full trees <-> this rank's blocks

    def shard(self, tree: Any, specs: Any) -> Any:
        """This rank's block of every leaf of ``tree`` by the spec tree
        ``specs`` (a ``P`` per tensor; ``None`` or a non-tensor leaf
        passes through): each named dimension cut into ``size(entry)``
        equal blocks, block ``index(entry)`` kept, as a new tensor."""
        def one(x, spec):
            if spec is None or not isinstance(x, torch.Tensor):
                return x
            if x.device.type == "meta":   # shapes only: GSPMD's padding
                return x.new_empty(self.block_shape(x.shape, spec))
            for d, entry in enumerate(spec):
                n = self.size(entry)
                if n == 1:
                    continue
                if x.shape[d] % n:
                    raise ValueError(
                        f"dimension {d} of {tuple(x.shape)} does not split "
                        f"into {n} blocks over {entry!r}")
                w = x.shape[d] // n
                x = x.narrow(d, self.index(entry) * w, w)
            return x.clone()
        return tree_map(one, tree, specs)

    def gather(self, tree: Any, specs: Any) -> Any:
        """The full tree from every rank's blocks (the inverse of
        :meth:`shard`): each named dimension all-gathered over its axes,
        the minor axis first."""
        def one(x, spec):
            if spec is None or not isinstance(x, torch.Tensor):
                return x
            for d, entry in enumerate(spec):
                for a in reversed(self._axes(entry)):
                    x = self.all_gather(x, a, d)
            return x
        return tree_map(one, tree, specs)

    def barrier(self) -> None:
        """Wait for every rank of the mesh (a recording mesh has no other
        rank)."""
        if not self.recording:
            dist.barrier(group=self.group)


def make_model_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...], *,
                    device=None) -> ModelMesh:
    """A model mesh of ``shape`` over the first ``prod(shape)`` ranks of the
    initialised default process group (``jax.make_mesh``'s counterpart):
    rank ``r`` at ``np.unravel_index(r, shape)``.  Every rank of the world
    must call it, in the same order as the others (creating a group is
    collective over the world).  ``device`` as in
    :func:`make_worker_mesh`."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_model_mesh needs an initialised default process group "
            "(torch.distributed.init_process_group, or run_workers)")
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         f"length")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = int(np.prod(shape))
    if world < n:
        raise ValueError(
            f"a {shape} model mesh needs {n} ranks; the world has {world} "
            f"(ranks 0-{world - 1})")
    grid = np.arange(n).reshape(shape)
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    member = rank < n
    dev = _lane_device(device) if member else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ModelMesh(shape, axis_names, rank, groups, dev,
                     group if member else None)


def make_recording_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                        rank: int = 0) -> ModelMesh:
    """The model mesh of ``shape`` as rank ``rank`` sees it (coordinates
    and ``index`` exactly :func:`make_model_mesh`'s) on
    ``core.lanes.RecordedLanes``: no process group, no
    ``torch.distributed``; its collectives only log (``record()`` is
    started) and return tensors of the right shape."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} and axes {axis_names} differ in "
                         f"length")
    if not 0 <= rank < int(np.prod(shape)):
        raise ValueError(f"rank {rank} is outside a {shape} mesh")
    mesh = ModelMesh(shape, axis_names, rank, None, torch.device("meta"))
    mesh.record()
    return mesh


def production_mesh_shape(multi_pod: bool):
    """The JAX package's production mesh, shape and axis names: one pod of
    :data:`CHIPS_PER_POD` as ``(data 16, model 16)``, or two of them as
    ``(pod 2, data 16, model 16)``."""
    side = math.isqrt(CHIPS_PER_POD)
    pod = (side, CHIPS_PER_POD // side)
    if multi_pod:
        return (2,) + pod, ("pod", "data", "model")
    return pod, ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ModelMesh:
    """The JAX package's production mesh (:func:`production_mesh_shape`);
    raises a ``ValueError`` naming the ranks it needs when the world is
    smaller."""
    shape, axes = production_mesh_shape(multi_pod)
    return make_model_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# Launching ranks


def _rank_main(fn, rank, n, backend, init_method, timeout_s, results):
    try:
        torch.set_num_threads(1)  # n ranks share the host's cores
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def run_workers(fn: Callable[[int], Any], n: int, *, backend: str = "gloo",
                init_method: Optional[str] = None,
                timeout: float = 300.0) -> List[Any]:
    """Spawn ``n`` ranks, join them into a ``backend`` process group and
    return ``[fn(0), ..., fn(n - 1)]``, each computed on its rank.

    ``fn`` must be picklable (a module-level function, or a
    ``functools.partial`` of one); each rank runs with one intra-op
    thread.  The group's rendezvous is a file under a fresh temporary
    directory unless ``init_method`` names another.  A rank that raises,
    dies or is still running after ``timeout`` seconds fails the call:
    every rank is then stopped and a ``RuntimeError`` carries the first
    failure's traceback."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    init = init_method or f"file://{os.path.join(tmp, 'rendezvous')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, init, timeout, results),
                         daemon=True) for r in range(n)]
    out: dict = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode}")
                elif time.monotonic() > deadline:
                    failure = (f"ranks {sorted(set(range(n)) - set(out))} "
                               f"still running after {timeout} s")
                continue
            if ok:
                out[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if failure is None:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_workers({n} ranks, {backend}): {failure}")
    return [out[r] for r in range(n)]
