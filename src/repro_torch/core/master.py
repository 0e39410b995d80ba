"""The virtual master: bulk work-stealing rebalancing (PyTorch port of
``repro.core.master``).

The paper's master thread is the *single stealer* for every worker queue
and decides when, from whom and to whom work moves (§II.B).  The JAX
package runs one lane's view of that under ``vmap`` / ``shard_map`` and
resolves its collectives through an axis name.  Here every lane-axis
collective passes through a lane-collectives object
(:mod:`repro_torch.core.lanes`, the ``lanes=`` argument):

* on :class:`~repro_torch.core.lanes.StackedLanes` (the default) the W
  lanes are the stacked ``(W, cap, ...)`` state on one device, and the
  lanes' ``all_gather`` of sizes or windows IS the stacked tensor;
* on :class:`~repro_torch.core.lanes.MeshLanes` this process holds one
  lane and the gathers are ``torch.distributed`` collectives.

A value every lane computes identically (the plan, the counters) is held
once, not once per lane.  On stacked lanes :class:`RebalanceStats`
counters are 0-d tensors and ``sizes_before`` / ``sizes_after`` are
``(W,)``, where the JAX package's vmapped stats carry a replicated copy
per lane; on a mesh each process's stats hold its own lane's sizes
(``(1,)``), its pod's counters and its row's cross-pod counters, which
:func:`repro_torch.core.lanes.stack_stats` assembles into that layout.

One round:

  1. the size vector (the master's bookkeeping);
  2. :func:`repro_torch.core.policy.plan_transfers` on it — the
     ``(victim -> thief, n)`` plan, at most one steal per victim;
  3. the block exchange, two implementations of the same plan
     (``StealPolicy.exchange``):

     ``"compact"`` (default)
         Every lane's raw ``(max_steal, ...)`` tail window is read in one
         K1 launch and gathered into one stack (on stacked lanes the K1
         output is the stack); the victims' detach is a cursor bump;
         every thief cuts its victim's segment out of the stack and
         splices it in one K4 launch.  The JAX
         package skips all of that with a ``lax.cond`` on rounds that move
         nothing; here the kernels always launch (no host read decides
         anything mid-round), and on such rounds every count is 0, so
         they write nothing and the state is bit-identical.
     ``"dense"``
         The victims' masked blocks (``steal_exact``, K1) are routed to
         their thieves (an all-to-all on a mesh) and spliced with one
         bulk push (K2).  Kept as the
         exchange oracle; its ``bytes_moved`` keeps the JAX package's
         ``W * max_steal * item_bytes`` all_to_all payload accounting.

Two-level rounds.  :func:`hierarchical_superstep` runs the same plan
within each pod and then across the pods' lane-0 representatives (the
paper's planned coordinator per machine group, §II.B).  The JAX package
vmaps one lane's view over a ``(pod, worker)`` grid; here a level is a
``(G, L)`` view of the stacked lanes — ``(P, W/P)`` for the pods,
``(W/P, P)`` for the rows that cross them — whose G plans
:func:`~repro_torch.core.policy.plan_transfers` computes at once and
whose group-local indices map to global lane indices, so each level is
ONE K1 window read and ONE K4 splice over all W lanes, never a loop over
pods.  On a mesh a level gathers over this lane's group only (its pod, or
its row across the pods), as the JAX package's ``superstep`` does over
one mesh axis.  :func:`exchange_probe` is the superstep's plan-and-exchange
prefix, collapsed by :func:`probe_token`; it never commits state.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import ops as bulk_ops
from repro_torch.core.lanes import StackedLanes
from repro_torch.core.ops import QueueState
from repro_torch.core.policy import StealPolicy, plan_transfers

__all__ = ["RebalanceStats", "superstep", "hierarchical_superstep",
           "gather_sizes", "exchange_probe", "probe_token", "Level"]

Pytree = Any
I32 = torch.int32


class RebalanceStats(NamedTuple):
    """Per-round observability.

    ``n_transferred`` / ``n_steals`` count the transfers of this round's
    plan.  ``bytes_moved`` is the payload one lane injects into the block
    exchange (items x item bytes): ``W * max_steal * item_bytes`` for the
    dense exchange, unconditionally, and ``max_steal * item_bytes`` for
    the compact exchange on rounds that transfer, 0 on rounds that do not
    (int32, saturated at INT32_MAX).

    Under :func:`hierarchical_superstep` the counters follow the JAX
    package's accounting, held once where it replicates them: the
    intra-pod share (``n_transferred``, ``n_steals``, ``bytes_moved``) is
    ``(P,)``, one value per pod (the JAX package's lane ``(p, 0)``), and
    the cross-pod share (``*_xpod``) is 0-d, the value its pod
    representatives hold (lane ``(p, 0)`` for any ``p``; the JAX lanes
    ``l > 0`` hold zeros there).  The exact totals are then
    ``sum(intra) + xpod``, and the busiest lane's payload
    ``max(bytes_moved) + bytes_moved_xpod``
    (:func:`repro_torch.runtime.telemetry.reduce_round_stats`).  The flat
    superstep fills the ``*_xpod`` fields with 0-d zeros.
    ``sizes_before`` / ``sizes_after`` are the ``(W,)`` size vectors in
    lane order at both levels (the JAX package's lanes hold their pod's
    slice of the first, and the pod-level gather as the second).
    """

    sizes_before: torch.Tensor   # (W,) int32
    sizes_after: torch.Tensor    # (W,) int32
    n_transferred: torch.Tensor  # () int32, (P,) hierarchical
    n_steals: torch.Tensor       # () int32, (P,) hierarchical
    bytes_moved: torch.Tensor    # () int32, (P,) hierarchical
    n_transferred_xpod: Any = 0  # () int32
    n_steals_xpod: Any = 0       # () int32
    bytes_moved_xpod: Any = 0    # () int32


def gather_sizes(q: QueueState, lanes=None) -> torch.Tensor:
    """The master's bookkeeping: every lane's queue size, in lane order —
    on stacked lanes, the ``(W,)`` size vector itself."""
    return (lanes or StackedLanes(q.size.shape[0])).all_gather(q.size)



def _payload(q: QueueState, rows: int) -> int:
    """Payload bytes of ``rows`` items, saturated at INT32_MAX."""
    item = sum(math.prod(b.shape[2:]) * b.element_size()
               for b in tree_leaves(q.buf))
    return min(rows * item, 2 ** 31 - 1)


def _steals(src: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """``(W, W)`` bool: ``[v, t]`` is True when thief ``t`` steals from
    victim ``v`` this round (at most one thief per victim)."""
    idx = torch.arange(src.shape[0], dtype=I32, device=src.device)
    return ((src[None, :] == idx[:, None]) & (amt > 0)[None, :]
            & (idx[None, :] != idx[:, None]))


def _dense_exchange(q, ops, lanes, policy, src, amt, donate
                    ) -> Tuple[QueueState, torch.Tensor]:
    """Victims detach masked blocks (K1), each block goes to its thief,
    thieves splice with one bulk push (K2)."""
    w = src.shape[0]
    steals = _steals(src, amt)
    stolen_amt = torch.where(steals, amt[None, :], 0).sum(1).to(I32)
    thief_id = torch.argmax(steals.to(I32), dim=1)  # 0 when none (amt == 0)

    # Victim severs its tail block — a single cursor bump linearizes.
    q, block, n_out = ops.steal_exact(q, lanes.local(stolen_amt),
                                      max_steal=policy.max_steal)

    # Route every non-empty block to its thief: owner[t] is t's victim.
    n_out = lanes.all_gather(n_out)
    dest = torch.where(n_out > 0, thief_id, w)  # row w collects the rest
    owner = torch.full((w + 1,), -1, dtype=torch.int64, device=dest.device)
    owner.scatter_(0, dest, torch.arange(w, device=dest.device))
    owner = lanes.local(owner[:w])
    has = owner >= 0
    sel = owner.clamp(min=0)
    recv_n = torch.where(has, n_out[sel], 0)
    stack = lanes.route(block, lanes.local(dest))
    recv = tree_map(
        lambda b: torch.where(has.reshape((-1,) + (1,) * (b.dim() - 1)),
                              b[sel], torch.zeros((), dtype=b.dtype,
                                                  device=b.device)), stack)
    q, _ = ops.push(q, recv, recv_n, donate=donate)
    bytes_moved = torch.full((), _payload(q, w * policy.max_steal),
                             dtype=I32, device=q.size.device)
    return q, bytes_moved


def _compact_exchange(q, ops, lanes, policy, sizes, src, amt, donate
                      ) -> Tuple[QueueState, torch.Tensor]:
    """Every lane's raw window (K1) + the thieves' fused cut-and-splice
    (K4)."""
    max_steal = policy.max_steal
    cap = tree_leaves(q.buf)[0].shape[1]
    idx = torch.arange(src.shape[0], dtype=I32, device=q.size.device)

    # Victim side: how much the plan severs from each lane.  The detach
    # is the cursor bump alone — the stack carries every raw window.
    stolen_amt = torch.where(_steals(src, amt), amt[None, :], 0).sum(1)
    n_out = torch.minimum(torch.clamp(lanes.local(stolen_amt).to(I32),
                                      min=0),
                          torch.clamp(q.size, max=max_steal))
    gathered = lanes.all_gather_tree(ops.window(q, max_steal=max_steal))
    q = QueueState(buf=q.buf, lo=(q.lo + n_out) % cap, size=q.size - n_out)

    # Thief side: the count is re-derived from the sizes gathered BEFORE
    # any cursor moved, so victim and thief agree exactly.
    is_thief = (amt > 0) & (src != idx)
    recv_n = torch.where(
        is_thief,
        torch.minimum(torch.clamp(amt, min=0),
                      torch.clamp(sizes[src.long()], max=max_steal)),
        0)
    q, _ = ops.transfer(q, gathered, lanes.local(src), lanes.local(recv_n),
                        max_steal=max_steal, donate=donate)
    bytes_moved = (amt > 0).any().to(I32) * _payload(q, max_steal)
    return q, bytes_moved


def _exchange(q, ops, lanes, policy, sizes, src, amt, exchange, donate
              ) -> Tuple[QueueState, torch.Tensor]:
    """The block exchange of a plan over the lanes of ``lanes``: ``sizes``,
    ``src`` and ``amt`` span all of them, ``q`` holds this process's."""
    if exchange == "dense":
        return _dense_exchange(q, ops, lanes, policy, src, amt, donate)
    if exchange == "compact":
        return _compact_exchange(q, ops, lanes, policy, sizes, src, amt,
                                 donate)
    raise ValueError(
        f"unknown exchange {exchange!r}; expected 'compact' or 'dense'")


def superstep(
    q: QueueState,
    policy: StealPolicy,
    *,
    ops: Optional[bulk_ops.BulkOps] = None,
    exchange: Optional[str] = None,
    plan: Optional[torch.Tensor] = None,
    sizes: Optional[torch.Tensor] = None,
    donate: bool = False,
    lanes=None,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[QueueState, RebalanceStats]:
    """One rebalancing round over the W lanes of ``q`` (stacked), or over
    the lanes of ``lanes`` (default: ``q``'s stack).

    ``ops`` is the :class:`~repro_torch.core.ops.BulkOps` backend serving
    the detach and the splice; when omitted it is resolved from
    ``policy.backend``.  ``exchange`` overrides
    ``policy.exchange``.  ``plan`` optionally substitutes the transfer
    plan (int32 ``(W, 2)``, the :func:`plan_transfers` layout); the
    caller must derive it from the size vector before any cursor moved,
    and may pass that vector as ``sizes`` (it is gathered otherwise).
    ``donate=True`` splices into the ring tensors of ``q`` in place (the
    runtime's own loop); ``donate=False`` leaves ``q`` untouched.  Nothing
    here reads a device value on the host, unless ``ops`` is the
    sanitizer's wrapper (``check=True`` or ``REPRO_CHECK=1``), which adds
    the conservation check of the sizes.  ``mark`` is the phase probe's
    boundary hook (:class:`repro_torch.obs.phase.PhaseClock.mark`),
    called with ``"exchange"`` once the exchange is issued.
    """
    if ops is None:
        ops = bulk_ops.make_ops(policy.backend)
    if exchange is None:
        exchange = policy.exchange
    lanes = lanes or StackedLanes(q.size.shape[0])
    before = q.size
    if sizes is None:
        sizes = gather_sizes(q, lanes)
    if plan is None:
        plan = plan_transfers(sizes, policy)
    src, amt = plan[:, 0], plan[:, 1]
    q, bytes_moved = _exchange(q, ops, lanes, policy, sizes, src, amt,
                               exchange, donate)
    if mark is not None:
        mark("exchange")
    _check_level(ops, lanes, before, q)
    zero = torch.zeros((), dtype=I32, device=q.size.device)
    stats = RebalanceStats(
        sizes_before=before,
        sizes_after=q.size,
        n_transferred=torch.where(amt > 0, amt, 0).sum().to(I32),
        n_steals=(amt > 0).sum().to(I32),
        bytes_moved=bytes_moved,
        n_transferred_xpod=zero,
        n_steals_xpod=zero,
        bytes_moved_xpod=zero,
    )
    return q, stats


def _check_level(ops, lanes, sizes_before, q) -> None:
    """``sizes_before``: this process's lanes' sizes before the level."""
    if ops.checked:
        # Sanitizer on: this level's exchange must conserve its sizes.
        from repro_torch.analysis import sanitize

        sanitize.trace_check_superstep(
            lanes.all_gather(sizes_before), lanes.all_gather(q.size),
            capacity=tree_leaves(q.buf)[0].shape[1])


def probe_token(q: QueueState) -> torch.Tensor:
    """Collapse a queue into one float32 value per lane that depends on
    its cursors AND its ring contents (one element per ring leaf) — the
    sink of the phase probe's prefix programs.  ``(W,)`` for stacked
    lanes, 0-d for one queue."""
    token = q.size.to(torch.float32) + q.lo.to(torch.float32)
    for leaf in tree_leaves(q.buf):
        token = token + leaf.reshape(q.size.shape + (-1,))[..., 0].to(
            torch.float32)
    return token


def exchange_probe(
    q: QueueState,
    policy: StealPolicy,
    *,
    ops: Optional[bulk_ops.BulkOps] = None,
    exchange: Optional[str] = None,
    plan: Optional[torch.Tensor] = None,
    lanes=None,
) -> torch.Tensor:
    """The superstep's size read + plan + block-exchange PREFIX, reduced by
    :func:`probe_token`: the same plan and the same exchange
    :func:`superstep` runs, on a copy of the rings (``donate=False``), so
    it never commits state.  Stats, the sanitizer hook and the
    post-exchange sizes belong to the tail the phase probe attributes by
    subtraction."""
    if ops is None:
        ops = bulk_ops.make_ops(policy.backend)
    if exchange is None:
        exchange = policy.exchange
    lanes = lanes or StackedLanes(q.size.shape[0])
    sizes = gather_sizes(q, lanes)
    if plan is None:
        plan = plan_transfers(sizes, policy)
    q, _ = _exchange(q, ops, lanes, policy, sizes, plan[:, 0], plan[:, 1],
                     exchange, donate=False)
    return probe_token(q)


class Level:
    """One level of a two-level round: the W lanes seen as G groups of L
    lanes.  ``Level(W, pod_size)`` is the pods, ``(P, W/P)``;
    ``Level(W, pod_size, across=True)`` is the rows across the pods,
    ``(W/P, P)``, whose group ``l`` is lane ``l`` of every pod.

    On stacked lanes (``lanes=None``) the level holds all G groups and
    one exchange serves them all.  On a mesh (``lanes`` a
    :class:`~repro_torch.core.lanes.MeshLanes` over the W lanes) it holds
    this lane's group only, as ``(1, L)``, and exchanges over that
    group's collectives."""

    def __init__(self, n_workers: int, pod_size: int, *,
                 across: bool = False, lanes=None):
        self.shape = (n_workers // pod_size, pod_size)
        self.across = across
        self.group_size = self.shape[0] if across else self.shape[1]
        self.lanes = lanes or StackedLanes(n_workers)
        if self.lanes.stacked:
            self.xlanes, self._mine = self.lanes, slice(None)
        else:
            lane = self.lanes.offset
            group = lane % pod_size if across else lane // pod_size
            self.xlanes = self.lanes.level(pod_size, across)
            self._mine = slice(group, group + 1)

    def view(self, v: torch.Tensor) -> torch.Tensor:
        """A ``(W,)`` vector every lane holds as this process's groups,
        ``(G, L)`` (a view, or a transposed one)."""
        g = v.reshape(self.shape)
        return (g.T if self.across else g)[self._mine]

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """This process's lanes' values (``(n_local,)``) gathered over its
        groups, as ``(G, L)``."""
        if self.lanes.stacked:
            return self.view(v)
        return self.xlanes.all_gather(v)[None]

    def unview(self, g: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`view`: ``(G, L)`` back to the lanes one
        exchange spans (``(W,)`` stacked, the group's ``L`` on a mesh)."""
        if not self.lanes.stacked:
            return g.reshape(-1)
        return (g.T if self.across else g).reshape(-1)

    def global_plan(self, plan: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(src, amt)`` in the exchange's lane indices (global on
        stacked lanes) from G group-local plans ``(G, L, 2)``."""
        if not self.lanes.stacked:
            return plan[0, :, 0], plan[0, :, 1]
        w = self.shape[0] * self.shape[1]
        members = self.view(torch.arange(w, dtype=torch.int64,
                                         device=plan.device))
        src = members.gather(-1, plan[..., 0].long()).to(I32)
        return self.unview(src), self.unview(plan[..., 1])

    def exchange(self, q, sizes, plan, *, ops, policy, exchange, donate
                 ) -> Tuple[QueueState, RebalanceStats]:
        """Execute G group plans ``(G, L, 2)`` planned from ``sizes``
        (``(G, L)``, the sizes the victims' and the thieves' clamps read)
        as one exchange over the level's lanes; the counters are per group
        (``(G,)``)."""
        src, amt = self.global_plan(plan)
        flat = self.unview(sizes)
        q_sized = QueueState(q.buf, q.lo, self.xlanes.local(flat))
        q_out, _ = _exchange(q_sized, ops, self.xlanes, policy, flat, src,
                             amt, exchange, donate)
        amt_g = plan[..., 1]
        if exchange == "dense":
            per = _payload(q, self.group_size * policy.max_steal)
            bytes_moved = torch.full(amt_g.shape[:1], per, dtype=I32,
                                     device=amt_g.device)
        else:
            bytes_moved = ((amt_g > 0).any(-1).to(I32)
                           * _payload(q, policy.max_steal))
        stats = RebalanceStats(
            sizes_before=q.size, sizes_after=q_out.size,
            n_transferred=torch.where(amt_g > 0, amt_g, 0).sum(-1).to(I32),
            n_steals=(amt_g > 0).sum(-1).to(I32),
            bytes_moved=bytes_moved)
        # the exchange moved the cursors by the sizes' change
        q_out = QueueState(q_out.buf, q_out.lo,
                           q.size + (q_out.size - q_sized.size))
        return q_out, stats


def _noop_plan_like(plan: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(plan.shape[-2], dtype=I32, device=plan.device)
    return torch.stack([idx.expand(plan.shape[:-1]),
                        torch.zeros(plan.shape[:-1], dtype=I32,
                                    device=plan.device)], dim=-1)


def _unless_dropped(plan: torch.Tensor,
                    drop: Optional[torch.Tensor]) -> torch.Tensor:
    """``plan``, or the plan that moves nothing where the 0-d ``drop`` is
    set (a dropped round of the fault layer); ``drop=None``: ``plan``."""
    if drop is None:
        return plan
    return torch.where(drop, _noop_plan_like(plan), plan)


def hierarchical_superstep(
    q: QueueState,
    policy: StealPolicy,
    *,
    pod_size: int,
    ops: Optional[bulk_ops.BulkOps] = None,
    exchange: Optional[str] = None,
    donate: bool = False,
    dead: Optional[torch.Tensor] = None,
    drop: Optional[torch.Tensor] = None,
    lanes=None,
    mark: Optional[Callable[[str], None]] = None,
) -> Tuple[QueueState, RebalanceStats]:
    """Two-level rebalancing of the W lanes in pods of ``pod_size``: the
    flat superstep within each pod, then one across the pods, where each
    pod's lane 0 is its representative and every other lane advertises
    the sentinel ``low_watermark + 1`` ("full enough not to be idle, small
    enough not to be a victim") so the plan ignores it.  Each level is one
    exchange over its lanes (see :class:`Level`); ``ops``, ``exchange``,
    ``donate`` and ``lanes`` as in :func:`superstep`, shared by both
    levels.  The stats follow :class:`RebalanceStats`' hierarchical
    layout.

    The fault layer's round passes ``dead`` (``(W,)`` bool, on every
    lane) and ``drop`` (0-d bool): dead lanes advertise the sentinel
    within their pod, a pod whose representative is dead abstains across
    the pods, and a dropped round plans no move at either level.
    ``mark`` (as in :func:`superstep`) closes the ``"exchange"`` phase
    after the intra-pod exchange; the cross-pod level falls in the
    splice's share, as in the JAX package's probe."""
    if ops is None:
        ops = bulk_ops.make_ops(policy.backend)
    if exchange is None:
        exchange = policy.exchange
    lanes = lanes or StackedLanes(q.size.shape[0])
    w = lanes.n
    if w % pod_size:
        raise ValueError(f"n_workers={w} not divisible by pod_size={pod_size}")
    pods = Level(w, pod_size, lanes=lanes)
    rows = Level(w, pod_size, across=True, lanes=lanes)
    kw = dict(ops=ops, policy=policy, exchange=exchange, donate=donate)
    sentinel = policy.low_watermark + 1

    before = q.size
    sizes = pods.gather(q.size)
    planned = sizes if dead is None else torch.where(
        pods.view(dead), sentinel, sizes).to(I32)
    plan = _unless_dropped(plan_transfers(planned, policy), drop)
    q, intra = pods.exchange(q, sizes, plan, **kw)
    if mark is not None:
        mark("exchange")
    _check_level(ops, lanes, before, q)

    # Across pods: only lane 0 of each pod takes part with its true size.
    rep = lanes.index(q.size.device) % pod_size == 0
    if dead is not None:
        rep = rep & ~lanes.local(dead)
    eff = torch.where(rep, q.size, sentinel).to(I32)
    mid = q.size
    eff = rows.gather(eff)
    xplan = _unless_dropped(plan_transfers(eff, policy), drop)
    q, xpod = rows.exchange(q, eff, xplan, **kw)
    _check_level(ops, lanes, mid, q)
    stats = intra._replace(
        sizes_after=q.size,
        n_transferred_xpod=xpod.n_transferred[0],
        n_steals_xpod=xpod.n_steals[0],
        bytes_moved_xpod=xpod.bytes_moved[0])
    return q, stats
