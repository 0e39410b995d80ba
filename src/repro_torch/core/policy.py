"""Steal policies and watermark scheduling for the virtual master (PyTorch
port of ``repro.core.policy``).

The paper's master (a) waits until a victim is *nearly drained* before
redistributing (§II.B), (b) steals a *proportion* of the victim's queue in
one bulk operation, and (c) is the only stealer.  These translate to a
deterministic plan computed from the lanes' size vector (see
``core.master``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.ops import f32_scalar

__all__ = ["StealPolicy", "proportional", "steal_half", "adaptive_chunk",
           "plan_transfers"]


@dataclasses.dataclass(frozen=True)
class StealPolicy:
    """Configuration of the master's rebalancing policy (the same fields
    and defaults as the JAX package's).

    Attributes:
      proportion: fraction of the victim's queue taken per steal (paper's
        ``steal(p)`` argument); a Python float or a float32 0-d tensor
        (the runtime's adaptive value).
      queue_limit: victims below this size are never stolen from (paper's
        ``_queue_limit_`` abort).
      low_watermark: a worker is *idle-eligible* (receives work) when its
        queue size is <= this.
      high_watermark: a worker is a steal *victim* only above this.
      max_steal: static upper bound on a single bulk transfer.
      backend: name of the :class:`repro_torch.core.ops.BulkOps` backend
        (``"reference"`` / ``"cuda"`` / ``"auto"``).
      exchange: ``"compact"`` (one ``(max_steal, ...)`` window per lane +
        the thief's fused cut-and-splice) or ``"dense"`` (the victim's
        masked block, routed to its thief); both execute the same plan.
    """

    proportion: float = 0.25
    queue_limit: int = 2
    low_watermark: int = 1
    high_watermark: int = 8
    max_steal: int = 256
    backend: str = "auto"
    exchange: str = "compact"


def proportional(p: float, **kw) -> StealPolicy:
    """The paper's policy: steal fraction ``p`` of the victim's tail."""
    return StealPolicy(proportion=p, **kw)


def steal_half(**kw) -> StealPolicy:
    """Hendler-Shavit steal-half (paper §V), the common-case default."""
    return StealPolicy(proportion=0.5, **kw)


def adaptive_chunk(n_idle: int, n_busy: int, base: float = 0.5) -> float:
    """Adnan-Sato-style dynamic chunk sizing (paper §V): scale the stolen
    proportion with the idle/busy imbalance."""
    if n_busy <= 0:
        return 0.0
    ratio = n_idle / max(n_idle + n_busy, 1)
    return float(min(max(base * 2 * ratio, 0.125), 0.75))


def plan_transfers(sizes: torch.Tensor, policy: StealPolicy) -> torch.Tensor:
    """A deterministic (victim -> thief) transfer plan from the int32
    ``(W,)`` size vector, or from a ``(G, W)`` matrix of G independent
    groups planned at once (the hierarchical superstep's pods).

    Returns int32 ``(..., W, 2)``: ``plan[i] = (src, n)`` means worker
    ``i`` *receives* ``n`` items stolen from ``src`` (``src == i``,
    ``n == 0`` when no transfer); indices are within the group.  The k-th
    most idle worker pairs with the k-th busiest victim — at most ONE
    steal per victim per round, the single-stealer invariant at superstep
    granularity.  Ranks use stable sorts on int keys, so ties break by
    lane index exactly as ``jnp.argsort`` breaks them; the steal count is
    ``floor(float32(size) * float32(proportion))``.
    """
    n = sizes.shape[-1]
    dev = sizes.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)

    idle = sizes <= policy.low_watermark
    victim = sizes >= max(policy.high_watermark, policy.queue_limit)

    # Rank idle workers (emptiest first) and victims (fullest first).
    big = 2 ** 30
    idle_order = torch.argsort(torch.where(idle, sizes, big), dim=-1,
                               stable=True)
    victim_order = torch.argsort(torch.where(victim, -sizes, big), dim=-1,
                                 stable=True)
    n_pairs = torch.minimum(idle.sum(-1), victim.sum(-1))
    live = idx < n_pairs[..., None]

    prop = f32_scalar(policy.proportion, dev)
    steal_n = torch.floor(torch.take_along_dim(sizes, victim_order, -1)
                          .to(torch.float32) * prop)
    steal_n = torch.clamp(steal_n.to(torch.int32), max=policy.max_steal)
    steal_n = torch.where(live, steal_n, 0)

    # Scatter the plan back to per-worker rows (thief-indexed); the idle
    # order is a permutation, so every row is written exactly once.
    src = idx.expand(sizes.shape).clone().scatter_(
        -1, idle_order, torch.where(live, victim_order, idle_order).to(
            torch.int32))
    amt = torch.zeros(sizes.shape, dtype=torch.int32,
                      device=dev).scatter_(-1, idle_order, steal_n)
    return torch.stack([src, amt], dim=-1)
