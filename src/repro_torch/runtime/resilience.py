"""Fault injection and recovery for the steal runtime on stacked lanes
(PyTorch port of ``repro.runtime.resilience``).

A dead worker is just a victim stolen at proportion 1.0: the paper's own
bulk steal is the recovery primitive.  This module supplies the
machinery around that observation:

* :class:`FaultPlan` — a deterministic, seedable schedule of injected
  failures (kill lane w at round r, drop one round's exchange, delay a
  lane's worker body by k rounds).  Re-stated from the JAX package
  (framework-free; ``FaultPlan.random`` draws from numpy's generator as
  the JAX package's does), so the same plan replays the same rounds in
  both packages.
* :class:`FaultState` — the host's mutable compilation of a plan into
  per-lane schedule arrays (kill round, one straggler window per lane,
  dropped rounds).  Before a block of k rounds the host turns it into
  a :class:`FaultContext`: the ``(k + 1, W)`` dead masks, the ``(k, W)``
  skip masks, the ``(k,)`` drop flags and each round's skipped lane
  indices among the lanes this process holds, uploaded once.
  :func:`ctx_round`, :func:`ctx_advance` and :func:`dead_mask` read a
  context as the JAX package's helpers read its schedule dict, and
  :func:`ctx_specs` says where its parts live on a mesh.  The
  schedule is the replicated master's view: every mesh rank holds all of
  it.  No host read decides anything mid-round (the
  executor's contract); the host knows the schedule, so it also knows
  which lanes of a round skip their body.
* :func:`make_resilient_lane` — the fault-aware round on the W lanes
  (stacked, or one per mesh rank through the lane collectives).  Per
  round, in the JAX package's order: (1) the worker body runs on EVERY
  lane and its effects are discarded on dead and delayed
  lanes (their rows are saved before the body and copied back after
  it, the JAX package's ``_select``); (2) the normal superstep executes
  the dead-masked plan; (3) one recovery superstep executes the dead-worker-as-victim plan at
  proportion 1.0, through the same exchange (K1 window, K4 splice).  A
  dropped round forces both plans empty.  With pods the round composes
  four plans: intra-pod normal, cross-pod normal (a pod whose
  representative is dead abstains), intra-pod recovery, and cross-pod
  recovery for entirely dead pods — each one exchange over all W lanes
  (:class:`repro_torch.core.master.Level`).
* :func:`mask_sizes` — the size vector the adaptive controller sees:
  dead lanes advertise the neither-idle-nor-busy sentinel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import master as master_ops
from repro_torch.core.lanes import StackedLanes
from repro_torch.core.master import _unless_dropped
from repro_torch.core.ops import QueueState
from repro_torch.core.policy import StealPolicy, plan_transfers

__all__ = [
    "NEVER",
    "FaultPlan",
    "FaultState",
    "FaultContext",
    "RoundFaults",
    "ctx_round",
    "ctx_advance",
    "ctx_specs",
    "dead_mask",
    "mask_sizes",
    "masked_plan",
    "recovery_plan",
    "make_resilient_lane",
]

Pytree = Any
I32 = torch.int32

# "This lane is never killed": any round index compares < NEVER.
NEVER = np.int32(2**31 - 1)


# ---------------------------------------------------------------------------
# Fault plans (framework-free, as in the JAX package)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected failures.

    Attributes:
      kills: ``(lane, round)`` pairs — lane ``lane`` dies at the START of
        round ``round`` (it executes no worker body from that round on
        and is masked out of every plan; its ring is drained by recovery
        steals).  Round indices are GLOBAL (``StealRuntime.rounds_run``
        numbering), so a plan replays identically across ``round()`` /
        ``run_fused`` boundaries.
      delays: ``(lane, round, k)`` triples — lane ``lane`` skips its
        worker body for rounds ``[round, round + k)`` (a straggler: it
        still takes part in exchanges, it just produces nothing).
      drops: round indices whose block exchange is dropped entirely (both
        the normal and the recovery plan move nothing that round).

    An empty ``FaultPlan()`` arms the fault machinery (recovery
    supersteps, mutable kill schedule) without scheduling any failure.
    """

    kills: Tuple[Tuple[int, int], ...] = ()
    delays: Tuple[Tuple[int, int, int], ...] = ()
    drops: Tuple[int, ...] = ()

    @classmethod
    def random(cls, n_workers: int, *, seed: int, n_kills: int = 1,
               n_delays: int = 0, n_drops: int = 0,
               max_round: int = 16, max_delay: int = 4) -> "FaultPlan":
        """A seeded random plan: ``n_kills`` distinct lanes killed (never
        lane 0, so at least one survivor remains), ``n_delays`` straggler
        windows and ``n_drops`` dropped exchanges, all in rounds
        ``[1, max_round)``.  The same seed gives the JAX package's plan."""
        rng = np.random.default_rng(seed)
        if n_kills >= n_workers:
            raise ValueError("cannot kill every lane")
        lanes = rng.choice(np.arange(1, n_workers), size=n_kills,
                           replace=False)
        kills = tuple((int(w), int(rng.integers(1, max_round)))
                      for w in lanes)
        delays = tuple((int(rng.integers(0, n_workers)),
                        int(rng.integers(1, max_round)),
                        int(rng.integers(1, max_delay + 1)))
                       for _ in range(n_delays))
        drops = tuple(int(rng.integers(1, max_round))
                      for _ in range(n_drops))
        return cls(kills=kills, delays=delays, drops=drops)

    def validate(self, n_workers: int) -> None:
        for w, r in self.kills:
            if not (0 <= w < n_workers):
                raise ValueError(f"kill lane {w} out of range [0, {n_workers})")
            if r < 0:
                raise ValueError(f"kill round {r} negative")
        for w, r, k in self.delays:
            if not (0 <= w < n_workers):
                raise ValueError(f"delay lane {w} out of range")
            if r < 0 or k < 1:
                raise ValueError(f"bad delay window ({r}, {k})")
        if len({w for w, _ in self.kills}) >= n_workers:
            raise ValueError("plan kills every lane; recovery needs a thief")


class RoundFaults(NamedTuple):
    """One round's slice of a :class:`FaultContext`, on the device."""

    dead: torch.Tensor     # (W,) bool — dead at this round
    skip: torch.Tensor     # (W,) bool — worker body discarded (dead | delayed)
    drop: torch.Tensor     # () bool — this round's exchanges dropped
    skip_idx: Optional[torch.Tensor]  # (n,) int64 lanes of skip; None if n=0
    index: int = 0         # the round's index (host)


class FaultContext(NamedTuple):
    """The schedule of a block of k rounds, uploaded once: ``dead`` is
    ``(k + 1, W)`` (row k is the round after the block, which the
    adaptive update of the last round reads), ``skip`` ``(k, W)``,
    ``drop`` ``(k,)``, and ``skip_idx`` the skipped lanes of every round
    in turn, round i's at ``skip_idx[skip_at[i]:skip_at[i + 1]]`` (host
    offsets); ``first`` is the index of the block's first round."""

    dead: torch.Tensor
    skip: torch.Tensor
    drop: torch.Tensor
    skip_idx: torch.Tensor
    skip_at: Tuple[int, ...]
    first: int = 0

    def round(self, i: int) -> RoundFaults:
        a, b = self.skip_at[i], self.skip_at[i + 1]
        return RoundFaults(self.dead[i], self.skip[i], self.drop[i],
                           self.skip_idx[a:b] if b > a else None,
                           self.first + i)


class FaultState:
    """Host-side, mutable compilation of a :class:`FaultPlan`.

    Owns the schedule arrays: ``kill_round[w]`` (NEVER = alive forever),
    one ``[delay_from, delay_until)`` straggler window per lane, and the
    padded ``drop_rounds`` vector — the JAX package's arrays, so a
    snapshot of either package restores into the other.  Mutation
    (:meth:`kill` for planned eviction or detected death, :meth:`revive`
    for grow / re-admission) changes values only."""

    def __init__(self, plan: FaultPlan, n_workers: int):
        plan.validate(n_workers)
        self.plan = plan
        self.n_workers = int(n_workers)
        self.kill_round = np.full((n_workers,), NEVER, np.int32)
        for w, r in plan.kills:
            self.kill_round[w] = min(self.kill_round[w], np.int32(r))
        self.delay_from = np.full((n_workers,), NEVER, np.int32)
        self.delay_until = np.full((n_workers,), NEVER, np.int32)
        for w, r, k in plan.delays:  # one window per lane; last wins
            self.delay_from[w] = np.int32(r)
            self.delay_until[w] = np.int32(r + k)
        drops = sorted(set(plan.drops))
        self.drop_rounds = np.asarray(drops or [-1], np.int32)

    # -- host mutation -------------------------------------------------------

    def kill(self, lane: int, at_round: int) -> None:
        self.kill_round[lane] = np.int32(min(int(self.kill_round[lane]),
                                             int(at_round)))

    def revive(self, lane: int) -> None:
        self.kill_round[lane] = NEVER

    def dead_at(self, round_index: int) -> np.ndarray:
        """(W,) bool: which lanes are dead at ``round_index``."""
        return np.asarray(self.kill_round) <= np.int32(round_index)

    def delayed_at(self, round_index: int) -> np.ndarray:
        """(W,) bool: which lanes skip their worker body as stragglers."""
        r = np.int32(round_index)
        return (self.delay_from <= r) & (r < self.delay_until)

    # -- the device context --------------------------------------------------

    def ctx(self, round0: int, k: int = 1, *, device=None,
            rows: Optional[Tuple[int, int]] = None) -> FaultContext:
        """The schedule of rounds ``[round0, round0 + k)`` as device masks,
        in one upload; ``skip_idx`` lists the skipped lanes among ``rows``,
        ``(first lane, lanes)`` held here (default: all W), as local row
        indices."""
        rounds = range(round0, round0 + k + 1)
        dead = np.stack([self.dead_at(r) for r in rounds])
        skip = dead[:k] | np.stack([self.delayed_at(r) for r in rounds][:k])
        drop = np.isin(np.arange(round0, round0 + k), self.drop_rounds)
        w = self.n_workers
        first, n_rows = rows or (0, w)
        mine = skip[:, first:first + n_rows]
        # One int64 upload: the masks, then every round's skipped lanes.
        lanes, at = np.nonzero(mine)[1], np.concatenate(
            [[0], np.cumsum(mine.sum(-1))])
        packed = torch.from_numpy(np.concatenate(
            [dead.reshape(-1), skip.reshape(-1), drop, lanes]
        ).astype(np.int64)).to(device)
        masks = packed[:(2 * k + 1) * w + k].bool()
        return FaultContext(
            dead=masks[:(k + 1) * w].reshape(k + 1, w),
            skip=masks[(k + 1) * w:(2 * k + 1) * w].reshape(k, w),
            drop=masks[(2 * k + 1) * w:],
            skip_idx=packed[(2 * k + 1) * w + k:],
            skip_at=tuple(int(a) for a in at), first=int(round0))

    # -- snapshot / restore --------------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {
            "kill_round": np.asarray(self.kill_round),
            "delay_from": np.asarray(self.delay_from),
            "delay_until": np.asarray(self.delay_until),
            "drop_rounds": np.asarray(self.drop_rounds),
        }

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        self.kill_round = np.asarray(state["kill_round"], np.int32).copy()
        self.delay_from = np.asarray(state["delay_from"], np.int32).copy()
        self.delay_until = np.asarray(state["delay_until"], np.int32).copy()
        self.drop_rounds = np.asarray(state["drop_rounds"], np.int32).copy()


# ---------------------------------------------------------------------------
# Reading a context (the JAX package's helpers over its schedule dict)


def ctx_round(ctx) -> int:
    """The round a context stands at: a block's first round, one round's
    own, or the bare round index that stands for the context when the
    fault layer is off (as the JAX package's context is then)."""
    if isinstance(ctx, FaultContext):
        return ctx.first
    if isinstance(ctx, RoundFaults):
        return ctx.index
    return ctx


def ctx_advance(ctx):
    """The context of the next round: the block without its first round
    (the schedule shared, nothing uploaded), or the round index + 1."""
    if isinstance(ctx, FaultContext):
        a = ctx.skip_at[1]
        return FaultContext(dead=ctx.dead[1:], skip=ctx.skip[1:],
                            drop=ctx.drop[1:], skip_idx=ctx.skip_idx[a:],
                            skip_at=tuple(x - a for x in ctx.skip_at[1:]),
                            first=ctx.first + 1)
    if isinstance(ctx, RoundFaults):
        raise TypeError("one round's RoundFaults hold no later round: "
                        "advance the block's FaultContext")
    return ctx + 1


def dead_mask(ctx) -> torch.Tensor:
    """``(W,)`` bool, every lane: the lanes dead at the context's round."""
    return ctx.dead[0] if isinstance(ctx, FaultContext) else ctx.dead


# Where the parts of a context live on a mesh (:func:`ctx_specs`).
REPLICATED = "replicated"   # the whole tensor on every rank
LOCAL = "local"             # this rank's rows only
HOST = "host"               # host values, the same on every rank


def ctx_specs(fault_active: bool):
    """Where a context lives when the lanes are ranks: the JAX package's
    ``shard_map`` specs for it, which replicate everything.  Here every
    rank uploads the whole schedule too (``FaultState.ctx``): the masks
    and drop flags are :data:`REPLICATED`, the skipped-lane indices
    :data:`LOCAL` (among the rows this rank's lanes hold, the ``rows=``
    of ``FaultState.ctx``) and the offsets and round index :data:`HOST`.
    With the fault layer off the context is the round index alone."""
    if not fault_active:
        return HOST
    return FaultContext(dead=REPLICATED, skip=REPLICATED, drop=REPLICATED,
                        skip_idx=LOCAL, skip_at=HOST, first=HOST)


def mask_sizes(sizes: torch.Tensor, dead: Optional[torch.Tensor],
               policy: StealPolicy) -> torch.Tensor:
    """The size vector as the adaptive controller should see it: dead
    lanes advertise the sentinel ``low_watermark + 1``, so a drained
    corpse never counts as an idle thief.  ``dead=None``: unchanged."""
    if dead is None:
        return sizes
    return torch.where(dead, policy.low_watermark + 1, sizes).to(I32)


# ---------------------------------------------------------------------------
# Plans: (W,) or batched (G, L) size vectors, the plan_transfers layout


def masked_plan(sizes: torch.Tensor, dead: torch.Tensor,
                policy: StealPolicy) -> torch.Tensor:
    """The normal plan with dead lanes masked out: they are neither
    idle-eligible (work must not move INTO a corpse) nor victims (their
    whole ring belongs to the recovery plan) — :func:`plan_transfers`
    over sizes where dead lanes advertise the sentinel.  Steal amounts
    read victim rows, which are alive, so the exchange clamps agree."""
    return plan_transfers(mask_sizes(sizes, dead, policy), policy)


def recovery_plan(sizes: torch.Tensor, dead: torch.Tensor, *,
                  max_steal: int, capacity: int,
                  thief_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dead-worker-as-victim plan: dead lanes that still hold work
    (fullest first) pair with surviving lanes (emptiest first), and each
    pair moves ``min(size, max_steal, thief free space)`` — proportion
    1.0, bounded per round by the exchange window.  Same layout as
    :func:`plan_transfers`, batched over leading dims the same way.

    ``thief_ok`` optionally restricts who may receive (the cross-pod
    recovery rows: a live pod's lane in some row may itself be dead)."""
    n = sizes.shape[-1]
    dev = sizes.device
    idx = torch.arange(n, dtype=I32, device=dev)
    victim = dead & (sizes > 0)
    thief = ~dead if thief_ok is None else (thief_ok & ~dead)
    big = 2 ** 30
    victim_order = torch.argsort(torch.where(victim, -sizes, big), dim=-1,
                                 stable=True)
    thief_order = torch.argsort(torch.where(thief, sizes, big), dim=-1,
                                stable=True)
    n_pairs = torch.minimum(victim.sum(-1), thief.sum(-1))
    live = idx < n_pairs[..., None]
    amt = torch.clamp(torch.take_along_dim(sizes, victim_order, -1),
                      max=max_steal)
    # Never overflow the thief: the free-space clamp is in the plan, so
    # victim and thief derive the same cut from it.
    amt = torch.minimum(amt, capacity - torch.take_along_dim(
        sizes, thief_order, -1))
    amt = torch.where(live, torch.clamp(amt, min=0), 0).to(I32)
    src = idx.expand(sizes.shape).clone().scatter_(
        -1, thief_order, torch.where(live, victim_order, thief_order).to(I32))
    amtv = torch.zeros(sizes.shape, dtype=I32, device=dev).scatter_(
        -1, thief_order, amt)
    return torch.stack([src, amtv], dim=-1)


# ---------------------------------------------------------------------------
# The fault-aware round on stacked lanes


def _rows(tree: Pytree, idx: torch.Tensor) -> Pytree:
    """Lanes ``idx`` of every leaf (a copy)."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _put_rows(tree: Pytree, idx: torch.Tensor, rows: Pytree, *,
              inplace: bool) -> Pytree:
    """``tree`` with lanes ``idx`` of every leaf set to ``rows``."""
    if inplace:
        return tree_map(lambda a, r: a.index_copy_(0, idx, r), tree, rows)
    return tree_map(lambda a, r: a.index_copy(0, idx, r), tree, rows)


def make_resilient_lane(policy: StealPolicy, ops, worker_fn, *,
                        pod_size: Optional[int] = None,
                        lanes=None) -> Callable:
    """The fault-injecting round on the W lanes (stacked, or ``lanes``):
    ``(q, carry, proportion, faults) -> (q, carry, stats)``, ``faults`` a
    :class:`RoundFaults` — what ``runtime.executor.make_lane_step`` returns
    with ``fault=True``, i.e. what ``StealRuntime`` runs when built with a
    :class:`FaultPlan`.

    The round splices into the rings of ``q`` in place (the runtime owns
    them).  The stats keep the round's full accounting (``sizes_before`` from
    before any exchange, ``sizes_after`` after recovery, counters
    summed).  With ``pod_size`` the cross-pod recovery counts are summed
    over the rows into the 0-d ``*_xpod`` counters, the JAX package's
    lane-0 accounting (see :class:`~repro_torch.core.master.RebalanceStats`;
    on a mesh each lane holds its row's share, and
    :func:`~repro_torch.core.lanes.stack_stats` sums them).

    The round takes an optional ``mark`` hook (the phase probe's
    :meth:`~repro_torch.obs.phase.PhaseClock.mark`): ``"worker_body"``
    after the masked worker body, ``"exchange"`` after the normal
    superstep's exchange (intra-pod in pods); the recovery supersteps
    and the cross-pod level fall in the splice's share, as in the JAX
    package's probe.
    """

    def body(q, carry, faults: RoundFaults):
        if worker_fn is None:
            return q, carry
        idx = faults.skip_idx
        if idx is None:
            return worker_fn(q, carry)
        # The body may write the rings in place: save the skipped lanes'
        # rows first, so each such lane ends exactly as it was.
        old_q, old_carry = _rows(q, idx), _rows(carry, idx)
        q_new, carry_new = worker_fn(q, carry)
        return (QueueState(_put_rows(q_new.buf, idx, old_q.buf, inplace=True),
                           q_new.lo.index_copy(0, idx, old_q.lo),
                           q_new.size.index_copy(0, idx, old_q.size)),
                _put_rows(carry_new, idx, old_carry, inplace=False))

    def flat_round(q, carry, proportion, faults: RoundFaults, mark=None):
        q, carry = body(q, carry, faults)
        if mark is not None:
            mark("worker_body")
        pol = dataclasses.replace(policy, proportion=proportion)
        cap = _cap(q)
        lanes_ = lanes or StackedLanes(q.size.shape[0])

        # Normal rebalancing over the survivors.
        sizes = lanes_.all_gather(q.size)
        plan = _unless_dropped(masked_plan(sizes, faults.dead, pol),
                               faults.drop)
        q, stats = master_ops.superstep(q, pol, ops=ops, plan=plan,
                                        sizes=sizes, donate=True,
                                        lanes=lanes_, mark=mark)
        # Recovery: dead rings stolen at proportion 1.0 by the least
        # loaded survivors, through the same exchange.
        sizes = lanes_.all_gather(q.size)
        rplan = _unless_dropped(
            recovery_plan(sizes, faults.dead, max_steal=pol.max_steal,
                          capacity=cap), faults.drop)
        q, rstats = master_ops.superstep(q, pol, ops=ops, plan=rplan,
                                         sizes=sizes, donate=True,
                                         lanes=lanes_)
        return q, carry, stats._replace(
            sizes_after=rstats.sizes_after,
            n_transferred=stats.n_transferred + rstats.n_transferred,
            n_steals=stats.n_steals + rstats.n_steals,
            bytes_moved=stats.bytes_moved + rstats.bytes_moved)

    def hier_round(q, carry, proportion, faults: RoundFaults, mark=None):
        q, carry = body(q, carry, faults)
        if mark is not None:
            mark("worker_body")
        pol = dataclasses.replace(policy, proportion=proportion)
        cap = _cap(q)
        lanes_ = lanes or StackedLanes(q.size.shape[0])
        pods = master_ops.Level(lanes_.n, pod_size, lanes=lanes_)
        rows = master_ops.Level(lanes_.n, pod_size, across=True,
                                lanes=lanes_)
        kw = dict(ops=ops, policy=pol, exchange=pol.exchange, donate=True)
        dead, drop = faults.dead, faults.drop
        pod_dead = dead.reshape(-1, pod_size).all(-1)          # (P,)

        # (1)-(2) The normal two-level superstep over the survivors: dead
        # lanes masked within their pod, a pod whose representative is
        # dead abstaining across the pods (its work still flows within).
        q, normal = master_ops.hierarchical_superstep(
            q, pol, pod_size=pod_size, ops=ops, exchange=pol.exchange,
            donate=True, dead=dead, drop=drop, lanes=lanes_, mark=mark)

        # (3) Intra-pod recovery: a dead LANE's ring drains into its
        # pod-mates (a no-op in an entirely dead pod).
        sizes2 = q.size
        pod_sizes = pods.gather(sizes2)                        # (P, L)
        rplan = _unless_dropped(
            recovery_plan(pod_sizes, pods.view(dead),
                          max_steal=pol.max_steal, capacity=cap), drop)
        q, irec = pods.exchange(q, pod_sizes, rplan, **kw)
        master_ops._check_level(ops, lanes_, sizes2, q)

        # (4) Cross-pod recovery: each row l drains the dead pods' lane-l
        # rings into the emptiest live pod's lane l.
        sizes3 = q.size
        row_sizes = rows.gather(sizes3)                        # (L, P)
        row_dead = rows.view(dead)                             # (L, P)
        xrplan = _unless_dropped(
            recovery_plan(row_sizes, pod_dead.expand_as(row_dead),
                          max_steal=pol.max_steal, capacity=cap,
                          thief_ok=~row_dead), drop)
        q, xrec = rows.exchange(q, row_sizes, xrplan, **kw)
        master_ops._check_level(ops, lanes_, sizes3, q)

        stats = normal._replace(
            sizes_after=q.size,
            n_transferred=normal.n_transferred + irec.n_transferred,
            n_steals=normal.n_steals + irec.n_steals,
            bytes_moved=normal.bytes_moved + irec.bytes_moved,
            n_transferred_xpod=(normal.n_transferred_xpod
                                + xrec.n_transferred.sum().to(I32)),
            n_steals_xpod=(normal.n_steals_xpod
                           + xrec.n_steals.sum().to(I32)),
            bytes_moved_xpod=normal.bytes_moved_xpod + xrec.bytes_moved[0])
        return q, carry, stats

    return flat_round if pod_size is None else hier_round


def _cap(q: QueueState) -> int:
    return tree_leaves(q.buf)[0].shape[1]
