"""DD-based branch-and-bound (PyTorch port of ``repro.core.dd.bnb``).

Each subproblem is a DD node (layer, state, value); exploring it builds a
restricted DD (primal bound), a relaxed DD (dual bound), and — when the
exact DD overflows the width budget — an exact frontier whose nodes become
the child subproblems (bulk generation: up to ``width`` children per
explore, the workload the paper's queue is built for).

The JAX package writes ``explore`` for one subproblem and ``vmap``s it.
Here :func:`explore_batch` on CUDA tensors is one launch of K5's redesign,
the fused DD explore (``kernels/dd_expand/explore.cu``): every layer of
all three DDs for the whole batch.  Its plain version,
:func:`explore_batch_plain`, takes the batch along the leading axis with
the layer ``lax.scan`` as a Python loop over the ``n_vars`` layers, in
plain PyTorch on any device; CPU tensors take it.  The sequential
``solve`` oracle is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.core.dd.diagram import (DEAD, NEG, build_bounds,
                                         expand_layer_plain, reduce_exact,
                                         root_pool, where_pool)
from repro_torch.kernels.dd_expand import ops as dd_expand

__all__ = ["Subproblem", "exact_frontier", "explore", "explore_batch",
           "explore_batch_plain"]


class Subproblem(NamedTuple):
    layer: torch.Tensor   # int32 — next variable to decide
    state: torch.Tensor   # int32 — remaining capacity
    value: torch.Tensor   # int32 — accumulated profit


def exact_frontier(root: Subproblem, weights, profits, *, width: int,
                   n_vars: int):
    """Expand EXACTLY until the pool would exceed ``width``, for a batch of
    ``(B,)`` roots.

    Returns (frontier Pool (B, width), frontier_layer, was_exact,
    exact_value): where the exact DD completes, was_exact is True and
    exact_value is the optimum of that subtree; otherwise the frontier
    nodes at ``frontier_layer`` partition the subtree exactly.
    """
    pool = root_pool(root.state, root.value, width)
    frontier = pool
    done = torch.zeros_like(root.layer, dtype=torch.bool)
    f_layer = torch.full_like(root.layer, -1)
    for i in range(n_vars):
        active = (root.layer <= i) & ~done
        new_pool, overflow = reduce_exact(
            expand_layer_plain(pool, weights[i], profits[i]), width)
        overflow = overflow & active
        # On overflow: freeze the PARENT pool as the frontier at layer i.
        frontier = where_pool(overflow, pool, frontier)
        f_layer = torch.where(overflow, i, f_layer)
        done = done | overflow
        pool = where_pool(active & ~overflow, new_pool, pool)
    was_exact = ~done
    exact_value = torch.where(pool.states >= 0, pool.values, NEG).amax(-1)
    return frontier, f_layer, was_exact, exact_value


def explore(sub: Subproblem, weights, profits, *, width: int,
            n_vars: int) -> Dict[str, object]:
    """Explore a batch of ``(B,)`` subproblems.  Returns a dict:
      primal: ``(B,)`` restricted-DD bound (a feasible completion value)
      dual:   ``(B,)`` relaxed-DD bound (upper bound on the subtree)
      exact:  ``(B,)`` bool — subtree solved exactly (no children)
      children: Subproblem batch ``(B, width)`` (dead slots layer = -1)
    """
    primal, dual = build_bounds(sub.state, sub.value, sub.layer,
                                weights, profits, width=width, n_vars=n_vars)
    frontier, f_layer, was_exact, exact_value = exact_frontier(
        sub, weights, profits, width=width, n_vars=n_vars)
    primal = torch.where(was_exact, exact_value, primal)
    dual = torch.where(was_exact, exact_value, dual)
    live = (frontier.states >= 0) & ~was_exact[:, None]
    children = Subproblem(
        layer=torch.where(live, f_layer[:, None], -1),
        state=torch.where(live, frontier.states, DEAD),
        value=torch.where(live, frontier.values, NEG),
    )
    return {"primal": primal, "dual": dual, "exact": was_exact,
            "children": children}


def explore_batch(subs: Subproblem, valid: torch.Tensor, weights, profits,
                  *, width: int, n_vars: int) -> Dict[str, object]:
    """:func:`explore` over an ``(E,)`` batch; invalid rows produce
    nothing.  On CUDA tensors one launch of the fused DD explore
    (``dd_expand.explore_fused``, pool widths 2 to 32); on CPU tensors
    :func:`explore_batch_plain`.  Both give the same integers."""
    if subs.state.device.type == "cpu":
        return explore_batch_plain(subs, valid, weights, profits,
                                   width=width, n_vars=n_vars)
    primal, dual, exact, *children = dd_expand.explore_fused(
        subs.layer, subs.state, subs.value, valid, weights, profits,
        width=width, n_vars=n_vars)
    return {"primal": primal, "dual": dual, "exact": exact,
            "children": Subproblem(*children)}


def explore_batch_plain(subs: Subproblem, valid: torch.Tensor, weights,
                        profits, *, width: int, n_vars: int
                        ) -> Dict[str, object]:
    """:func:`explore_batch` in plain PyTorch, on any device: what the
    fused kernel is held against."""
    out = explore(subs, weights, profits, width=width, n_vars=n_vars)
    primal = torch.where(valid, out["primal"], NEG)
    dual = torch.where(valid, out["dual"], NEG)
    ch = out["children"]
    live = valid[:, None] & (ch.layer >= 0)
    children = Subproblem(
        layer=torch.where(live, ch.layer, -1),
        state=torch.where(live, ch.state, DEAD),
        value=torch.where(live, ch.value, NEG),
    )
    return {"primal": primal, "dual": dual,
            "exact": out["exact"] & valid, "children": children}
