"""Vectorized decision-diagram layer expansion: exact / restricted / relaxed
(PyTorch port of ``repro.core.dd.diagram``).

A DD layer is a fixed-width node pool, batched over any leading dims:
  states (..., W) int32 — remaining capacity (-1 = dead slot)
  values (..., W) int32 — longest path value into the node

``expand_layer`` generates both arcs for every node through K5
(``kernels/dd_expand/expand.cu``).  The reductions and the bounds built
from them are plain PyTorch on any device and expand through K5's plain
version: on the card the solver runs them all at once in K5's redesign,
the fused explore (``bnb.explore_batch``), and these are its plain
version.  Reductions:

  exact:      merge duplicate states (keep max value); reports overflow
              when distinct states exceed the pool width.
  restricted: keep the top-W nodes by value (primal bound; paper Fig. 3).
  relaxed:    keep the top W-1 by value, MERGE the rest into one node with
              state = max(states), value = max(values) (dual bound; Fig. 4).

Every result must equal the JAX package's bit for bit, including which of
several tied nodes survives: ``jnp.lexsort`` is two stable sorts here
(by value, then by state), and ``lax.top_k``, which breaks ties by the
lower index, is a stable descending sort cut to k (never ``torch.topk``,
whose tie order is unspecified).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.dd_expand import ops as dd_expand
from repro_torch.kernels.dd_expand.ref import expand_ref

__all__ = ["Pool", "DEAD", "NEG", "expand_layer", "expand_layer_plain",
           "reduce_exact",
           "reduce_restricted", "reduce_relaxed", "root_pool", "where_pool",
           "build_bounds"]

DEAD = -1
NEG = -(2 ** 30)


class Pool(NamedTuple):
    states: torch.Tensor   # (..., W) int32, -1 = dead
    values: torch.Tensor   # (..., W) int32


def expand_layer(pool: Pool, w, p) -> Pool:
    """One DD layer: each live node spawns the 0-arc child (state, value)
    and the 1-arc child (state - w, value + p) when feasible.  Returns a
    (..., 2W) pool (children may be dead).  This is K5
    (``kernels/dd_expand``): one launch on the card, its plain version on
    the CPU."""
    return Pool(*dd_expand.expand_pool(pool.states, pool.values, w, p))


def expand_layer_plain(pool: Pool, w, p) -> Pool:
    """:func:`expand_layer` through K5's plain version, on any device."""
    return Pool(*expand_ref(pool.states, pool.values, w, p))


def _dedup_max(states: torch.Tensor, values: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge duplicate states keeping the max value (exact DD reduction):
    sort by (state, value) — ``jnp.lexsort((values, states))`` as two
    stable sorts — and mask all but the last (best) copy of each state."""
    by_value = torch.argsort(values, dim=-1, stable=True)
    by_state = torch.argsort(states.gather(-1, by_value), dim=-1, stable=True)
    order = by_value.gather(-1, by_state)
    s = states.gather(-1, order)
    v = values.gather(-1, order)
    is_last = torch.cat([s[..., 1:] != s[..., :-1],
                         torch.ones_like(s[..., :1], dtype=torch.bool)],
                        dim=-1)
    keep = is_last & (s >= 0)
    return torch.where(keep, s, DEAD), torch.where(keep, v, NEG)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last dim, descending, ties by
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def reduce_exact(children: Pool, width: int) -> Tuple[Pool, torch.Tensor]:
    """Dedup; returns (pool (..., W), overflow flag) — overflow set when more
    than ``width`` distinct states survive."""
    s, v = _dedup_max(children.states, children.values)
    n_live = (s >= 0).sum(-1)
    topv, idx = _top_k(torch.where(s >= 0, v, NEG), width)
    dead = topv <= NEG
    return (Pool(states=torch.where(dead, DEAD, s.gather(-1, idx)),
                 values=torch.where(dead, NEG, topv)),
            n_live > width)


def reduce_restricted(children: Pool, width: int) -> Pool:
    """Top-W by value (after dedup) — primal-side restricted DD."""
    s, v = _dedup_max(children.states, children.values)
    topv, idx = _top_k(torch.where(s >= 0, v, NEG), width)
    dead = topv <= NEG
    return Pool(states=torch.where(dead, DEAD, s.gather(-1, idx)),
                values=torch.where(dead, NEG, topv))


def reduce_relaxed(children: Pool, width: int) -> Pool:
    """Top-(W-1) by value; the remainder merges into one relaxed node with
    state = max(rest states), value = max(rest values)."""
    s, v = _dedup_max(children.states, children.values)
    topv, idx = _top_k(torch.where(s >= 0, v, NEG), width - 1)
    kept = torch.zeros_like(s, dtype=torch.bool).scatter(-1, idx, topv > NEG)
    rest = (s >= 0) & ~kept
    any_rest = rest.any(-1, keepdim=True)
    merged_s = torch.where(rest, s, DEAD).amax(-1, keepdim=True)
    merged_v = torch.where(rest, v, NEG).amax(-1, keepdim=True)
    dead = topv <= NEG
    states = torch.cat([torch.where(dead, DEAD, s.gather(-1, idx)),
                        torch.where(any_rest, merged_s, DEAD)], dim=-1)
    values = torch.cat([torch.where(dead, NEG, topv),
                        torch.where(any_rest, merged_v, NEG)], dim=-1)
    return Pool(states=states, values=values)


def root_pool(state: torch.Tensor, value: torch.Tensor, width: int) -> Pool:
    """``(B, width)`` pools holding one root node each in slot 0."""
    b = state.shape[0]
    s = torch.full((b, width), DEAD, dtype=torch.int32, device=state.device)
    v = torch.full((b, width), NEG, dtype=torch.int32, device=state.device)
    s[:, 0] = state
    v[:, 0] = value
    return Pool(s, v)


def where_pool(mask: torch.Tensor, new: Pool, old: Pool) -> Pool:
    """Per batch row: ``new`` where the ``(B,)`` mask holds, else ``old``."""
    m = mask[:, None]
    return Pool(torch.where(m, new.states, old.states),
                torch.where(m, new.values, old.values))


def build_bounds(root_state: torch.Tensor, root_value: torch.Tensor,
                 start_layer: torch.Tensor, weights: torch.Tensor,
                 profits: torch.Tensor, *, width: int, n_vars: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Restricted + relaxed DDs from a batch of ``(B,)`` subproblem roots.

    Walks all ``n_vars`` layers; layers before a root's ``start_layer`` are
    masked no-ops, so roots at different depths share one batch.  Returns
    ``(B,)`` (primal, dual) bounds for root_value + completion.  Plain
    PyTorch on any device.
    """
    res = root_pool(root_state, root_value, width)
    rel = root_pool(root_state, root_value, width)
    for i in range(n_vars):
        active = start_layer <= i
        w, p = weights[i], profits[i]
        res = where_pool(active, reduce_restricted(
            expand_layer_plain(res, w, p), width), res)
        rel = where_pool(active, reduce_relaxed(
            expand_layer_plain(rel, w, p), width), rel)
    primal = torch.where(res.states >= 0, res.values, NEG).amax(-1)
    dual = torch.where(rel.states >= 0, rel.values, NEG).amax(-1)
    return primal, dual
