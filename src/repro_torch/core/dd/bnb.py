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
plain PyTorch on any device; CPU tensors take it.  :func:`solve` is the
sequential (single-stack) branch-and-bound oracle the parallel solver is
held against, one :func:`explore_batch` per step.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch._tree import resolve_device
from repro_torch.core.dd.diagram import (DEAD, NEG, build_bounds,
                                         expand_layer_plain, reduce_exact,
                                         root_pool, where_pool)
from repro_torch.core.dd.knapsack import Knapsack
from repro_torch.kernels.dd_expand import ops as dd_expand

__all__ = ["Subproblem", "exact_frontier", "explore", "explore_batch",
           "explore_batch_plain", "solve"]


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


def solve(inst: Knapsack, width: int = 32, batch: int = 16,
          max_steps: int = 10_000, *, device=None) -> Tuple[int, dict]:
    """Sequential (single-stack) DD branch-and-bound — the oracle the
    parallel master-worker solver must agree with.  ``device=None`` means
    CUDA (one launch of the fused explore per step) and raises without
    it; ``device="cpu"`` runs :func:`explore_batch_plain`.

    The JAX package's loop, step for step: take the first ``batch``
    subproblems of the stack, pad the batch with ``-1`` rows, raise the
    incumbent to the batch's best primal bound, prune a subproblem whose
    dual bound does not beat the incumbent (unless it was solved
    exactly), and append the others' children in row order.  Each step
    uploads the batch once and reads the incumbent and the decision
    arrays back in one packed transfer.  Returns ``(optimum, stats)``
    with the JAX package's ``explored`` / ``pruned`` / ``generated`` /
    ``supersteps`` counts.
    """
    dev = resolve_device(device)
    w = torch.tensor(inst.weights, dtype=torch.int32, device=dev)
    p = torch.tensor(inst.profits, dtype=torch.int32, device=dev)
    stack = [(0, inst.capacity, 0)]
    incumbent = -(2 ** 30)
    stats = {"explored": 0, "pruned": 0, "generated": 1, "supersteps": 0}
    valid_rows = torch.arange(batch, device=dev)

    while stack and stats["explored"] < max_steps:
        take, stack = stack[:batch], stack[batch:]
        n_take = len(take)
        arr = np.full((3, batch), -1, np.int32)
        arr[:, :n_take] = np.asarray(take, np.int32).T
        sub = torch.from_numpy(arr).to(dev)
        out = explore_batch(Subproblem(sub[0], sub[1], sub[2]),
                            valid_rows < n_take, w, p, width=width,
                            n_vars=inst.n)
        ch = out["children"]
        packed = torch.cat([
            out["primal"].amax().reshape(1), out["dual"],
            out["exact"].to(torch.int32),
            ch.layer.reshape(-1), ch.state.reshape(-1),
            ch.value.reshape(-1)]).cpu().numpy()
        stats["explored"] += n_take
        stats["supersteps"] += 1
        incumbent = max(incumbent, int(packed[0]))
        duals, exact = packed[1:1 + batch], packed[1 + batch:1 + 2 * batch]
        kids = packed[1 + 2 * batch:].reshape(3, batch, -1)
        for e in range(n_take):
            if duals[e] <= incumbent and not exact[e]:
                stats["pruned"] += 1
                continue
            for j in np.flatnonzero(kids[0, e] >= 0):
                stack.append((int(kids[0, e, j]), int(kids[1, e, j]),
                              int(kids[2, e, j])))
                stats["generated"] += 1
    return incumbent, stats
