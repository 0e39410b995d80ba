"""Mixture-of-Experts with BULK-STEAL token rebalancing (port of
``repro.models.moe``).

The paper's technique inside the model: after top-k routing each expert is
a worker whose queue is its batch of assigned tokens.  An expert past its
``capacity`` would drop its overflow (GShard); here one deterministic pass,
the virtual master, bulk-steals the overflow suffix and hands it to the
experts with slack:

  1. routing = bulk push: an assignment's slot within its expert is its
     rank in one stable sort by expert (constant cost per token);
  2. overflow = the capacity guard;
  3. reassignment = proportional bulk steal: the j-th overflowing
     assignment goes to the j-th unit of slack across experts, found by
     one ``searchsorted`` over the cumulative slack (one cut per expert).

The plan ``(expert, slot, valid)`` is integer arithmetic and equals the
JAX package's bit for bit: the top-k is a stable descending sort (ties to
the lower expert, as ``lax.top_k``), every sort is stable, and each
``searchsorted`` takes the JAX call's side.  ``bulk_steal=False`` is the
GShard drop baseline.  The expert products are batched matmuls over
``(E, C, D)`` buffers, as the JAX package's einsums are (no Pallas kernel
there).

``impl="ep_shardmap"`` is explicit expert parallelism
(:func:`moe_apply_ep_shardmap`, the JAX package's ``shard_map`` body):
under an active model mesh each model rank holds ``E / tp`` experts, runs
the same routing plan, computes its own experts' tokens and adds its
share into one SUM all-reduce per chunk over the model axis.  Without a
mesh, or where ``E % tp != 0``, it is the dispatch below, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ShardPlan, _active_mesh, dense_init

Pytree = Any

__all__ = ["moe_init", "moe_apply", "moe_apply_ep_shardmap",
           "route_with_bulk_steal", "MOE_CHUNK_TOKENS"]

IMPLS = ("gspmd", "ep_shardmap")

# Token-chunk size of the dispatch pipeline: the (E, C, D) buffers and the
# routing tensors scale with the chunk, not with the whole batch.  One
# chunk is one bulk push + steal round.
MOE_CHUNK_TOKENS = 65_536


def moe_init(gen: torch.Generator, L: int, d_model: int, n_experts: int,
             d_ff_e: int, dtype) -> Pytree:
    """Router and SwiGLU experts for L stacked layers."""
    return {
        "router": dense_init(gen, (L, d_model, n_experts), dtype),
        "w_gate": dense_init(gen, (L, n_experts, d_model, d_ff_e), dtype),
        "w_up": dense_init(gen, (L, n_experts, d_model, d_ff_e), dtype),
        "w_down": dense_init(gen, (L, n_experts, d_ff_e, d_model), dtype),
    }


# ---------------------------------------------------------------------------
# routing with bulk-steal rebalancing
# ---------------------------------------------------------------------------


def route_with_bulk_steal(probs: torch.Tensor, top_k: int, capacity: int,
                          bulk_steal: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """(expert, slot, weight, valid) for each of the T * top_k assignments
    of the ``(T, E)`` router softmax ``probs``, flat, in token-major order.

    expert: int32 expert id (re-routed by the steal); slot: int32 position
    in that expert's capacity buffer; weight: the router probability,
    renormalized over the token's top k (a stolen assignment keeps its
    original expert's weight: the thief computes on its behalf); valid:
    the assignment has a real slot (false only when the whole layer is
    over capacity, or, without the steal, past its expert's capacity).
    """
    T, E = probs.shape
    dev = probs.device
    w, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, experts = w[:, :top_k], experts[:, :top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    flat_e = experts.reshape(-1)                          # (A,), A = T * k
    flat_w = w.reshape(-1)
    A = flat_e.shape[0]

    # bulk push: slot = rank of the assignment within its expert
    order = torch.sort(flat_e, stable=True).indices
    inv = torch.empty_like(order)
    inv[order] = torch.arange(A, device=dev)
    sorted_e = flat_e[order]
    ids = torch.arange(E, device=dev)
    start = torch.searchsorted(sorted_e, ids, side="left")
    end = torch.searchsorted(sorted_e, ids, side="right")
    slot = inv - start[flat_e]
    load = end - start                                    # (E,) loads

    overflow = slot >= capacity
    if not bulk_steal:
        return (flat_e.int(), torch.clamp(slot, max=capacity - 1).int(),
                flat_w, ~overflow)

    # proportional bulk steal of the overflow suffix: one searchsorted over
    # the cumulative slack maps the j-th overflow to its thief
    slack = torch.clamp(capacity - load, min=0)
    cum_slack = torch.cumsum(slack, 0)
    total_slack = cum_slack[-1]
    ovf = overflow.long()
    ovf_rank = torch.cumsum(ovf, 0) - ovf                 # routing order
    thief = torch.clamp(torch.searchsorted(cum_slack, ovf_rank, side="right"),
                        max=E - 1)
    prev_cum = torch.where(thief > 0,
                           cum_slack[torch.clamp(thief - 1, min=0)], 0)
    thief_slot = load[thief] + (ovf_rank - prev_cum)

    stolen_ok = overflow & (ovf_rank < total_slack)
    new_e = torch.where(stolen_ok, thief, flat_e)
    new_slot = torch.clamp(torch.where(stolen_ok, thief_slot, slot), 0,
                           capacity - 1)
    valid = ~overflow | stolen_ok
    return new_e.int(), new_slot.int(), flat_w, valid


def capacity_of(tokens: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    """Slots per expert for a chunk of ``tokens``: in Python floats, as
    the JAX package computes it, rounded up to a multiple of 8."""
    capacity = int(max(tokens * top_k / n_experts * capacity_factor, top_k))
    return -(-capacity // 8) * 8


def _moe_chunk(p: Pytree, xt: torch.Tensor, *, top_k: int, n_experts: int,
               capacity_factor: float, compute_dtype, bulk_steal: bool,
               experts: Optional[range] = None) -> torch.Tensor:
    """MoE of one ``(Tc, D)`` token chunk; with ``experts`` (a range of
    expert ids whose weights ``p`` holds, in order) only their share."""
    Tc, D = xt.shape
    E, cd = n_experts, compute_dtype
    probs = torch.softmax((xt @ p["router"].to(cd)).float(), dim=-1)
    capacity = capacity_of(Tc, top_k, E, capacity_factor)
    expert, slot, weight, valid = route_with_bulk_steal(
        probs, top_k, capacity, bulk_steal=bulk_steal)
    tok = torch.arange(Tc, device=xt.device).repeat_interleave(top_k)
    if experts is not None:  # keep the assignments of this rank's experts
        expert = expert.long() - experts.start
        valid = valid & (expert >= 0) & (expert < len(experts))
        E = len(experts)

    # dispatch into the (E, C, D) buffers; assignments without a slot go
    # to a spare last row, which is cut off (JAX's mode="drop")
    rows = E * capacity
    flat_idx = torch.where(valid, expert.long() * capacity + slot.long(),
                           rows)
    buf = torch.zeros((rows + 1, D), dtype=cd, device=xt.device)
    buf = buf.index_put((flat_idx,), xt[tok])[:rows].view(E, capacity, D)

    # the experts: grouped SwiGLU products
    h = F.silu(torch.bmm(buf, p["w_gate"].to(cd)))
    h = h * torch.bmm(buf, p["w_up"].to(cd))
    out_buf = torch.bmm(h, p["w_down"].to(cd)).reshape(rows, D)

    # combine: gather back, weight, and sum each token's k assignments
    # (tok repeats every token k times in a row, so the JAX package's
    # scatter-add is this sum)
    gathered = out_buf[torch.clamp(flat_idx, max=rows - 1)]
    gathered = gathered * (weight * valid.float()).to(cd)[:, None]
    return gathered.view(Tc, top_k, D).sum(1)


def _chunks(xt: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` over the fewest equal chunks of at most ``MOE_CHUNK_TOKENS``
    rows that divide ``xt``'s, concatenated."""
    T, D = xt.shape
    if T <= MOE_CHUNK_TOKENS:
        return fn(xt)
    nc = -(-T // MOE_CHUNK_TOKENS)
    while T % nc:
        nc += 1
    return torch.cat([fn(c) for c in xt.view(nc, T // nc, D)])


def moe_apply_ep_shardmap(p: Pytree, x: torch.Tensor, *, top_k: int,
                          n_experts: int, capacity_factor: float, sh,
                          compute_dtype, bulk_steal: bool = True):
    """Explicit expert parallelism under the active model mesh (the JAX
    package's ``shard_map`` body, ``repro.models.moe``).

    Each rank holds its block as the body's ``in_specs`` give it: the
    router whole, and of ``w_gate`` / ``w_up`` / ``w_down`` the ``E / tp``
    experts of its model rank (``index * E / tp`` on); ``x`` (B, S, D) its
    rows (the data parallelism is the caller's).  Every model rank routes
    the same tokens to the same plan, gathers and computes only its own
    experts' assignments, and the ranks' outputs are summed by one SUM
    all-reduce per chunk over the model axis.  Returns None where the JAX
    package's body does: no mesh, no ``sh.tp`` axis, or ``E % tp != 0``.
    """
    mesh = _active_mesh()
    if mesh is None or sh.tp not in mesh.shape:
        return None
    tp = mesh.shape[sh.tp]
    if n_experts % tp:
        return None
    Eo = n_experts // tp
    if p["w_gate"].shape[0] != Eo:
        raise ValueError(f"a rank of {tp} holds {Eo} of {n_experts} "
                         f"experts, not {p['w_gate'].shape[0]}")
    first = mesh.coords[sh.tp] * Eo
    B, S, D = x.shape
    kw = dict(top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, compute_dtype=compute_dtype,
              bulk_steal=bulk_steal, experts=range(first, first + Eo))

    def chunk(xt):
        return mesh.all_reduce(_moe_chunk(p, xt, **kw), sh.tp, "sum")

    return _chunks(x.reshape(B * S, D).to(compute_dtype), chunk
                   ).view(B, S, D)


def moe_apply(p: Pytree, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float, compute_dtype, bulk_steal: bool = True,
              impl: str = "gspmd", sh=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D); ``p`` leaves are one layer's (no L dim).

    Tokens are routed in chunks of at most ``MOE_CHUNK_TOKENS`` (the
    fewest equal chunks that divide B * S): the steal's scope is the chunk.
    ``impl="ep_shardmap"`` under a model mesh is
    :func:`moe_apply_ep_shardmap` (``sh``: the shard plan, default
    ``ShardPlan()``); otherwise the dispatch runs here whole.
    """
    if impl not in IMPLS:
        raise ValueError(f"moe impl {impl!r} not in {IMPLS}")
    kw = dict(top_k=top_k, n_experts=n_experts,
              capacity_factor=capacity_factor, compute_dtype=compute_dtype,
              bulk_steal=bulk_steal)
    if impl == "ep_shardmap":
        out = moe_apply_ep_shardmap(p, x, sh=sh or ShardPlan(), **kw)
        if out is not None:
            return out
    B, S, D = x.shape
    return _chunks(x.reshape(B * S, D).to(compute_dtype),
                   lambda xt: _moe_chunk(p, xt, **kw)).view(B, S, D)
