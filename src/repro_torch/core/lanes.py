"""The lane collectives: how a round's lane-axis operations resolve
(the port's counterpart of the JAX package's axis-name collectives).

The JAX package writes one lane's view of a round and resolves its
``all_gather`` / ``all_to_all`` / ``psum`` / ``pmax`` through an axis
name, under ``vmap`` (every lane on one device) or ``shard_map`` (one
lane per device).  The port passes every such operation through one of
two objects with the same surface:

:class:`StackedLanes`
    All W lanes stacked on this process (``(W, cap, ...)`` rings).  The
    gather IS the stacked tensor and the max is ``amax`` broadcast back
    to the W lanes; no operation adds a launch or a host read.
:class:`MeshLanes`
    One lane on this process, its ring ``(1, cap, ...)``; every operation
    is a ``torch.distributed`` collective over the mesh's ranks or over
    one level's group (the pods, or the rows that cross them).  Under
    ``gloo`` a CUDA tensor is staged through the host around each
    collective (chosen by the group's backend name); under ``nccl`` it
    stays on the device.

Either way a value a collective returns is identical on every lane, so
the plan, the counters and the proportion computed from it are too.
``n`` is the lane count the operations span, ``n_local`` the lanes this
process holds, ``index`` their positions among the ``n``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._tree import tree_leaves, tree_unflatten

__all__ = ["StackedLanes", "MeshLanes", "stack_stats"]

I32 = torch.int32


class StackedLanes:
    """The W lanes stacked on this process: every collective is the
    identity on the stack, or a reduction of it."""

    stacked = True
    writer = True  # this process writes the lanes' snapshots

    def __init__(self, n: int):
        self.n = self.n_local = int(n)
        self.offset = 0

    def index(self, device) -> torch.Tensor:
        return torch.arange(self.n, dtype=I32, device=device)

    def local(self, x):
        """This process's rows of a vector over the ``n`` lanes."""
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def all_gather_tree(self, tree: Any) -> Any:
        return tree

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Every lane gets the max over all lanes of ``x`` (``(W,)``)."""
        return x.amax().expand(x.shape[0]).clone()

    def route(self, block: Any, dest: torch.Tensor) -> Any:
        """Each lane's block sent to lane ``dest`` (``n``: nowhere); what
        the lanes here receive, as one ``(n, ...)`` stack per leaf indexed
        by the SENDING lane — on stacked lanes, the blocks themselves."""
        del dest
        return block

    def gather_objects(self, objs: List[Any]) -> List[Any]:
        """Per-lane Python objects of all ``n`` lanes, in lane order."""
        return objs

    def broadcast_tree(self, tree: Any, src: int) -> Any:
        """Lane ``src``'s ``tree`` on every lane — here, ``tree`` itself
        (this process holds lane ``src``)."""
        del src
        return tree

    def owns(self, worker: int) -> bool:
        return 0 <= worker < self.n

    def barrier(self) -> None:
        pass


class MeshLanes:
    """One lane on this process, the others on the ranks of ``group``:
    lane ``i`` of the ``n`` is the group's rank ``i`` (a level's group
    lists its ranks in ascending order, so a pod's group holds its lanes
    in lane order and a row's its pods in pod order)."""

    stacked = False
    n_local = 1

    def __init__(self, group, n: int, position: int, *, writer: bool,
                 levels=None):
        self.group = group
        self.n = int(n)
        self.offset = int(position)
        self.writer = writer
        self._levels = levels
        # gloo takes host tensors: a CUDA tensor travels through the host
        self.staged = dist.get_backend(group) == "gloo"

    def level(self, pod_size: int, across: bool) -> "MeshLanes":
        """The collectives of this lane's pod (``across=False``) or of its
        row across the pods (``across=True``)."""
        if self._levels is None:
            raise ValueError("these lanes have no pod levels")
        return self._levels(pod_size, across)

    def index(self, device) -> torch.Tensor:
        return torch.full((1,), self.offset, dtype=I32, device=device)

    def local(self, x):
        return x[self.offset:self.offset + 1]

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.staged else t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (``(r, ...)``; a lane's is ``(1, ...)``) of every lane,
        concatenated ``(n * r, ...)`` in lane order."""
        wire = self._to_wire(x)
        out = torch.empty((self.n * wire.shape[0],) + tuple(wire.shape[1:]),
                          dtype=wire.dtype, device=wire.device)
        _all_gather(out, wire, self.group)
        return out.to(x.device)

    def all_gather_tree(self, tree: Any) -> Any:
        """Every leaf (``(1, ...)``) of every lane, stacked ``(n, ...)``:
        the leaves travel as one byte row per lane, in one collective."""
        leaves = tree_leaves(tree)
        packed = _pack(leaves)
        out = self.all_gather(packed)
        return tree_unflatten(tree, _unpack(out, leaves))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        wire = self._to_wire(x).clone()
        dist.all_reduce(wire, op=op, group=self.group)
        return wire.to(x.device)

    def route(self, block: Any, dest: torch.Tensor) -> Any:
        """An all-to-all of ``n`` chunks, only the chunk of lane ``dest``
        populated (the JAX package's ``n * max_steal * item_bytes``
        payload); row ``v`` of the result is what lane ``v`` sent here."""
        leaves = tree_leaves(block)
        packed = _pack(leaves)                               # (1, B)
        # row n (no thief) falls off the end of the send buffer
        send = torch.zeros((self.n + 1, packed.shape[1]), dtype=torch.uint8,
                           device=packed.device)
        send.index_copy_(0, dest.reshape(1).to(torch.int64), packed)
        wire = self._to_wire(send[:self.n])
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        return tree_unflatten(block, _unpack(out.to(packed.device), leaves))

    def broadcast_tree(self, tree: Any, src: int) -> Any:
        """Lane ``src``'s ``tree`` on every lane: its leaves (any shapes)
        travel as one byte row in one broadcast from ``src``.  Every lane
        passes a tree of the same structure, shapes and dtypes; only
        ``src``'s values matter."""
        leaves = tree_leaves(tree)
        flat = torch.cat([leaf.contiguous().reshape(-1).view(torch.uint8)
                          for leaf in leaves])
        wire = self._to_wire(flat)
        dist.broadcast(wire, src=dist.get_global_rank(self.group, int(src)),
                       group=self.group)
        wire, out, at = wire.to(flat.device), [], 0
        for leaf in leaves:
            width = leaf.numel() * leaf.element_size()
            out.append(wire[at:at + width].clone().view(leaf.dtype)
                       .reshape(leaf.shape))
            at += width
        return tree_unflatten(tree, out)

    def gather_objects(self, objs: List[Any]) -> List[Any]:
        out: List[Any] = [None] * self.n
        dist.all_gather_object(out, objs, group=self.group)
        return [o for part in out for o in part]

    def owns(self, worker: int) -> bool:
        return worker == self.offset

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # torch 2.13 renames all_gather_into_tensor to all_gather_single
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _pack(leaves: List[torch.Tensor]) -> torch.Tensor:
    """``(L, ...)`` leaves as one ``(L, bytes)`` uint8 row per lane."""
    rows = leaves[0].shape[0]
    return torch.cat([leaf.contiguous().reshape(rows, -1).view(torch.uint8)
                      for leaf in leaves], dim=1)


def _unpack(packed: torch.Tensor, like: List[torch.Tensor]
            ) -> List[torch.Tensor]:
    """The inverse of :func:`_pack` for ``packed.shape[0]`` lanes of
    leaves shaped as ``like``'s rows."""
    rows, out, at = packed.shape[0], [], 0
    for leaf in like:
        width = int(np.prod(leaf.shape[1:], dtype=np.int64)) * \
            leaf.element_size()
        part = packed[:, at:at + width].contiguous().view(leaf.dtype)
        out.append(part.reshape((rows,) + tuple(leaf.shape[1:])))
        at += width
    return out


def stack_stats(lanes, per_round: list, *, pod_size: Optional[int]) -> list:
    """Each round's :class:`~repro_torch.core.master.RebalanceStats` in the
    stacked layout (``(W,)`` sizes; 0-d counters flat, ``(P,)`` intra-pod
    and 0-d cross-pod counters in pods) on every lane.

    On stacked lanes the rounds' stats already are.  On a mesh each lane
    holds its own size before and after, its pod's intra-pod counters and
    its row's cross-pod counters (row ``l`` is lane ``l`` of every pod);
    one gather of the block's records over the mesh assembles the stacked
    layout: the pods' counters from each pod's lane 0, the cross-pod
    counts summed over the rows, the cross-pod payload row 0's (the JAX
    package's lane-0 accounting)."""
    if lanes.stacked or not per_round:
        return per_round
    cls = type(per_round[0])
    k = len(per_round)
    rec = torch.stack([torch.cat([torch.as_tensor(f).reshape(-1).to(I32)
                                  for f in stats]) for stats in per_round])
    g = lanes.all_gather(rec[None])                       # (W, k, 8)
    w = g.shape[0]
    out = []
    for r in range(k):
        x = g[:, r]
        if pod_size is None:
            counters = [x[0, c] for c in range(2, 8)]
        else:
            pods = x.reshape(w // pod_size, pod_size, -1)
            counters = [pods[:, 0, 2], pods[:, 0, 3], pods[:, 0, 4],
                        pods[0, :, 5].sum().to(I32),
                        pods[0, :, 6].sum().to(I32), x[0, 7]]
        n_tr, n_st, b, n_tr_x, n_st_x, b_x = counters
        out.append(cls(sizes_before=x[:, 0], sizes_after=x[:, 1],
                       n_transferred=n_tr, n_steals=n_st, bytes_moved=b,
                       n_transferred_xpod=n_tr_x, n_steals_xpod=n_st_x,
                       bytes_moved_xpod=b_x))
    return out
