"""The virtual master: bulk work-stealing rebalancing on stacked lanes
(PyTorch port of ``repro.core.master``).

The paper's master thread is the *single stealer* for every worker queue
and decides when, from whom and to whom work moves (§II.B).  The JAX
package runs one lane's view of that under ``vmap`` / ``shard_map`` and
resolves its collectives through an axis name.  This port runs on one
GPU and works on the stacked ``(W, cap, ...)`` state directly:

* the lanes' ``all_gather`` of sizes or windows IS the stacked tensor;
* ``psum(1)`` over the lane axis is ``W``;
* a value every lane computed identically (the plan, the counters) is
  held once, not once per lane — so :class:`RebalanceStats` counters are
  0-d tensors and ``sizes_before`` / ``sizes_after`` are ``(W,)``, where
  the JAX package's vmapped stats carry a replicated copy per lane.

One round:

  1. the size vector (the master's bookkeeping);
  2. :func:`repro_torch.core.policy.plan_transfers` on it — the
     ``(victim -> thief, n)`` plan, at most one steal per victim;
  3. the block exchange, two implementations of the same plan
     (``StealPolicy.exchange``):

     ``"compact"`` (default)
         Every lane's raw ``(max_steal, ...)`` tail window is read in one
         K1 launch (the stack the all_gather would build); the victims'
         detach is a cursor bump; every thief cuts its victim's segment
         out of the stack and splices it in one K4 launch.  The JAX
         package skips all of that with a ``lax.cond`` on rounds that move
         nothing; here the kernels always launch (no host read decides
         anything mid-round), and on such rounds every count is 0, so
         they write nothing and the state is bit-identical.
     ``"dense"``
         The victims' masked blocks (``steal_exact``, K1) are routed to
         their thieves and spliced with one bulk push (K2).  Kept as the
         exchange oracle; its ``bytes_moved`` keeps the JAX package's
         ``W * max_steal * item_bytes`` all_to_all payload accounting.

``hierarchical_superstep`` and ``exchange_probe`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core import ops as bulk_ops
from repro_torch.core.ops import QueueState
from repro_torch.core.policy import StealPolicy, plan_transfers

__all__ = ["RebalanceStats", "superstep", "gather_sizes"]

Pytree = Any
I32 = torch.int32


class RebalanceStats(NamedTuple):
    """Per-round observability.

    ``n_transferred`` / ``n_steals`` count the transfers of this round's
    plan.  ``bytes_moved`` is the payload one lane injects into the block
    exchange (items x item bytes): ``W * max_steal * item_bytes`` for the
    dense exchange, unconditionally, and ``max_steal * item_bytes`` for
    the compact exchange on rounds that transfer, 0 on rounds that do not
    (int32, saturated at INT32_MAX).  The JAX package's ``*_xpod`` fields
    belong to the hierarchical superstep, which is not ported yet.
    """

    sizes_before: torch.Tensor   # (W,) int32
    sizes_after: torch.Tensor    # (W,) int32
    n_transferred: torch.Tensor  # () int32
    n_steals: torch.Tensor       # () int32
    bytes_moved: torch.Tensor    # () int32


def gather_sizes(q: QueueState) -> torch.Tensor:
    """The master's bookkeeping: every lane's queue size, in lane order —
    on stacked lanes, the ``(W,)`` size vector itself."""
    return q.size



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


def _dense_exchange(q, ops, policy, src, amt, donate
                    ) -> Tuple[QueueState, torch.Tensor]:
    """Victims detach masked blocks (K1), each block goes to its thief,
    thieves splice with one bulk push (K2)."""
    w = q.size.shape[0]
    steals = _steals(src, amt)
    stolen_amt = torch.where(steals, amt[None, :], 0).sum(1).to(I32)
    thief_id = torch.argmax(steals.to(I32), dim=1)  # 0 when none (amt == 0)

    # Victim severs its tail block — a single cursor bump linearizes.
    q, block, n_out = ops.steal_exact(q, stolen_amt,
                                      max_steal=policy.max_steal)

    # Route every non-empty block to its thief: owner[t] is t's victim.
    dest = torch.where(n_out > 0, thief_id, w)  # row w collects the rest
    owner = torch.full((w + 1,), -1, dtype=torch.int64, device=dest.device)
    owner.scatter_(0, dest, torch.arange(w, device=dest.device))
    owner = owner[:w]
    has = owner >= 0
    sel = owner.clamp(min=0)
    recv_n = torch.where(has, n_out[sel], 0)
    recv = tree_map(
        lambda b: torch.where(has.reshape((w,) + (1,) * (b.dim() - 1)),
                              b[sel], torch.zeros((), dtype=b.dtype,
                                                  device=b.device)), block)
    q, _ = ops.push(q, recv, recv_n, donate=donate)
    bytes_moved = torch.full((), _payload(q, w * policy.max_steal),
                             dtype=I32, device=q.size.device)
    return q, bytes_moved


def _compact_exchange(q, ops, policy, sizes, src, amt, donate
                      ) -> Tuple[QueueState, torch.Tensor]:
    """Every lane's raw window (K1) + the thieves' fused cut-and-splice
    (K4)."""
    max_steal = policy.max_steal
    cap = tree_leaves(q.buf)[0].shape[1]
    idx = torch.arange(q.size.shape[0], dtype=I32, device=q.size.device)

    # Victim side: how much the plan severs from each lane.  The detach
    # is the cursor bump alone — the stack carries every raw window.
    stolen_amt = torch.where(_steals(src, amt), amt[None, :], 0).sum(1)
    n_out = torch.minimum(torch.clamp(stolen_amt.to(I32), min=0),
                          torch.clamp(q.size, max=max_steal))
    gathered = ops.window(q, max_steal=max_steal)
    q = QueueState(buf=q.buf, lo=(q.lo + n_out) % cap, size=q.size - n_out)

    # Thief side: the count is re-derived from the sizes gathered BEFORE
    # any cursor moved, so victim and thief agree exactly.
    is_thief = (amt > 0) & (src != idx)
    recv_n = torch.where(
        is_thief,
        torch.minimum(torch.clamp(amt, min=0),
                      torch.clamp(sizes[src.long()], max=max_steal)),
        0)
    q, _ = ops.transfer(q, gathered, src, recv_n, max_steal=max_steal,
                        donate=donate)
    bytes_moved = (amt > 0).any().to(I32) * _payload(q, max_steal)
    return q, bytes_moved


def superstep(
    q: QueueState,
    policy: StealPolicy,
    *,
    ops: Optional[bulk_ops.BulkOps] = None,
    exchange: Optional[str] = None,
    plan: Optional[torch.Tensor] = None,
    donate: bool = False,
) -> Tuple[QueueState, RebalanceStats]:
    """One rebalancing round over the W stacked lanes of ``q``.

    ``ops`` is the :class:`~repro_torch.core.ops.BulkOps` backend serving
    the detach and the splice; when omitted it is resolved from
    ``policy.backend``.  ``exchange`` overrides
    ``policy.exchange``.  ``plan`` optionally substitutes the transfer
    plan (int32 ``(W, 2)``, the :func:`plan_transfers` layout); the
    caller must derive it from the size vector before any cursor moved.
    ``donate=True`` splices into the ring tensors of ``q`` in place (the
    runtime's own loop); ``donate=False`` leaves ``q`` untouched.  Nothing
    here reads a device value on the host, unless ``ops`` is the
    sanitizer's wrapper (``check=True`` or ``REPRO_CHECK=1``), which adds
    the conservation check of the sizes.
    """
    if ops is None:
        ops = bulk_ops.make_ops(policy.backend)
    if exchange is None:
        exchange = policy.exchange
    sizes = gather_sizes(q)
    if plan is None:
        plan = plan_transfers(sizes, policy)
    src, amt = plan[:, 0], plan[:, 1]

    if exchange == "dense":
        q, bytes_moved = _dense_exchange(q, ops, policy, src, amt, donate)
    elif exchange == "compact":
        q, bytes_moved = _compact_exchange(q, ops, policy, sizes, src, amt,
                                           donate)
    else:
        raise ValueError(
            f"unknown exchange {exchange!r}; expected 'compact' or 'dense'")

    if ops.checked:
        # Sanitizer on: this round must conserve its sizes.
        from repro_torch.analysis import sanitize

        sanitize.trace_check_superstep(
            sizes, q.size, capacity=tree_leaves(q.buf)[0].shape[1])
    stats = RebalanceStats(
        sizes_before=sizes,
        sizes_after=q.size,
        n_transferred=torch.where(amt > 0, amt, 0).sum().to(I32),
        n_steals=(amt > 0).sum().to(I32),
        bytes_moved=bytes_moved,
    )
    return q, stats
