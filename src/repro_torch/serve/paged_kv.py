"""Paged KV-cache block manager for decode-step serving (port of
``repro.serve.paged_kv``).

vLLM-style paging adapted to the steal runtime's lane discipline: each
queue LANE owns one fixed page pool per attention layer group
(``(n_pages + 1, NG, page_size, K, hd)`` — the extra page is the trash
page inactive slots point at), a page table ``(n_slots, pages_per_seq)``
of page ids, and an owner vector ``(n_pages,)`` mapping each physical
page back to the slot holding it (-1 = free).  Every operation here is
tensor arithmetic on the device with no host read, so the allocator runs
INSIDE the decode worker body, and page pressure becomes a real
scheduling signal: a slot whose next page cannot be allocated this round
simply stalls.

The allocator and the gather / scatter take an optional leading lane axis
(``table (n, S, PP)``, ``owner (n, P)``, pool leaves ``(n, P + 1, ...)``):
the port's worker body runs all the lanes it holds at once, where the JAX
package writes one lane and maps it with ``jax.vmap``.

Lane ownership invariant: a page is referenced by at most one live slot
of its own lane, pages never alias across lanes, and a finished slot's
pages return to the free list in the SAME round its output record is
pushed.  A bulk steal of QUEUED requests moves no pages (queued items are
KV-free prefill work); migrating an IN-FLIGHT request moves its pages
with it (:class:`repro_torch.serve.decode.DecodeCluster`).

Layout: :func:`gather_slot_caches` returns the caches in the layout the
port's batched ``DecoderLM.decode_step`` consumes — one batch row per
slot, ``(NG, rows, C, K, hd)`` leaves and a ``(rows,)`` position vector —
where the JAX package returns per-slot batch-1 caches ``(S, NG, 1, C, K,
hd)`` for ``jax.vmap``; the values are the same.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.serve.kv_cache import cache_tokens, pad_cache

Pytree = Any
I32 = torch.int32

__all__ = ["pages_for", "make_pool", "alloc_pages", "free_pages",
           "gather_slot_caches", "written_rows", "scatter_slot_caches",
           "cache_to_pages", "pages_to_cache", "pool_token_count",
           "PagedKVError"]


class PagedKVError(ValueError):
    """Raised when a model/policy combination cannot be paged."""


def pages_for(seq_len: int, page_size: int) -> int:
    """Pages needed to hold ``seq_len`` KV rows."""
    return -(-int(seq_len) // int(page_size))


# ---------------------------------------------------------------------------
# Pool construction
# ---------------------------------------------------------------------------


def make_pool(model, *, n_slots: int, n_pages: int, page_size: int,
              pages_per_seq: int, device=None) -> Dict[str, Any]:
    """One lane's paged-KV state (no lane axis; stack for W lanes), on
    ``device`` (default CUDA; raises without it).

    Returns a dict with:
      ``pages``: per layer-group ``{"k"/"v": (n_pages + 1, NG, page_size,
        K, hd)}`` — page ``n_pages`` is the trash page unseated table
        entries point at (its content is never read unmasked).
      ``table``: ``(n_slots, pages_per_seq)`` int32 page ids.
      ``owner``: ``(n_pages,)`` int32 owning slot per page, -1 = free.

    Only linear (global-attention) caches page cleanly — a sliding-window
    ring cache re-layouts slots as ``pos % C``, which breaks the page-id ->
    position mapping — so windowed layer kinds are rejected.
    """
    dev = resolve_device(device)
    probe = int(page_size) * max(int(pages_per_seq), 2)
    for kind in model.layer_kinds:
        if model.cache_len(kind, probe) != probe:
            raise PagedKVError(
                f"layer kind {kind!r} uses a ring (windowed) cache; paged "
                f"decode requires linear caches — use a no-window config "
                f"(e.g. configs.reduced drops the window)")
    proto = model.make_cache(1, int(page_size), device=dev)
    pages = {                          # proto leaves (NG, 1, ps, K, hd)
        g: tree_map(lambda x: torch.zeros(
            (int(n_pages) + 1, x.shape[0]) + tuple(x.shape[2:]),
            dtype=x.dtype, device=dev), kv)
        for g, kv in proto.items() if g != "pos"
    }
    return {
        "pages": pages,
        "table": torch.full((int(n_slots), int(pages_per_seq)),
                            int(n_pages), dtype=I32, device=dev),
        "owner": torch.full((int(n_pages),), -1, dtype=I32, device=dev),
    }


# ---------------------------------------------------------------------------
# The allocator (runs inside the decode worker body)
# ---------------------------------------------------------------------------


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(I32), dim=-1, dtype=I32)


def alloc_pages(table: torch.Tensor, owner: torch.Tensor,
                n_alloc: torch.Tensor, need: torch.Tensor,
                page_idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grant one page to each needing slot, free list permitting.

    Args:
      table: ``(..., n_slots, pages_per_seq)`` page ids.
      owner: ``(..., n_pages)`` owning slot per page (-1 free).
      n_alloc: ``(..., n_slots)`` pages currently held per slot.
      need: ``(..., n_slots)`` bool — slot wants one more page this round.
      page_idx: ``(..., n_slots)`` the table column the new page fills
        (``pos // page_size``).

    The i-th needing slot (slot order) takes the i-th free page (page
    order) — a deterministic rank-matching every execution mode computes
    identically.  Slots beyond the free-page supply are not granted
    (their ``n_alloc`` is unchanged, so the caller's ``advance`` mask
    stalls them — back-pressure, not an error).  Returns ``(table, owner,
    n_alloc)``.
    """
    n_slots, pp = table.shape[-2], table.shape[-1]
    n_pages = owner.shape[-1]
    free = owner < 0
    n_need = need.to(I32).sum(-1, keepdim=True, dtype=I32)
    n_free = free.to(I32).sum(-1, keepdim=True, dtype=I32)
    # i-th needing slot <-> i-th free page; argsort of the int key is
    # stable, as jnp.argsort(~need) is
    slot_order = torch.argsort((~need).to(I32), dim=-1, stable=True)
    free_rank = _cumsum(free) - 1                     # rank among free
    assign = free & (free_rank < n_need)
    slot_of_page = torch.gather(
        slot_order, -1, free_rank.clamp(0, n_slots - 1).long())
    owner = torch.where(assign, slot_of_page.to(I32), owner)
    # Scatter granted page ids into the table.  The JAX package drops the
    # writes of non-assigned pages (and of columns past the table) with
    # mode="drop"; here they land on one spare row that is sliced off.
    col = torch.gather(page_idx, -1, slot_of_page).long()
    keep = assign & (col >= 0) & (col < pp)
    flat = torch.where(keep, slot_of_page * pp + col, n_slots * pp)
    ext = torch.cat([table.reshape(table.shape[:-2] + (n_slots * pp,)),
                     table.new_zeros(table.shape[:-2] + (1,))], dim=-1)
    ids = torch.arange(n_pages, dtype=I32, device=table.device)
    ext = ext.scatter(-1, flat, ids.expand(owner.shape))
    table = ext[..., :n_slots * pp].reshape(table.shape)
    need_rank = _cumsum(need) - 1
    granted = need & (need_rank < n_free)
    n_alloc = n_alloc + granted.to(I32)
    return table, owner, n_alloc


def free_pages(table: torch.Tensor, owner: torch.Tensor,
               n_alloc: torch.Tensor, retire: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return every page owned by a retiring slot to the free list, in
    the same round the slot's output record is pushed.  Returns
    ``(table, owner, n_alloc)`` with retired rows pointing at trash."""
    n_slots = table.shape[-2]
    n_pages = owner.shape[-1]
    retire_pad = torch.cat([retire, retire.new_zeros(
        retire.shape[:-1] + (1,))], dim=-1)           # guard for owner = -1
    freed = (owner >= 0) & torch.gather(
        retire_pad, -1, owner.clamp(0, n_slots).long())
    owner = torch.where(freed, torch.full_like(owner, -1), owner)
    table = torch.where(retire[..., None], torch.full_like(table, n_pages),
                        table)
    n_alloc = torch.where(retire, torch.zeros_like(n_alloc), n_alloc)
    return table, owner, n_alloc


# ---------------------------------------------------------------------------
# Gather / scatter between the pool and per-slot caches
# ---------------------------------------------------------------------------


def _page_rows(leaf: torch.Tensor, table: torch.Tensor):
    """The pool leaf as ``(NG, lanes * (P + 1), ps, K, hd)`` (a view) and
    the flat page id of every table entry, lane by lane."""
    lanes = 1
    for d in table.shape[:-2]:
        lanes *= d
    p1 = leaf.shape[-5]
    pool = leaf.view((lanes * p1,) + tuple(leaf.shape[-4:])).transpose(0, 1)
    base = torch.arange(lanes, device=table.device).reshape(
        table.shape[:-2] + (1, 1)) * p1
    return pool, (table.long() + base).reshape(-1)


def gather_slot_caches(pages: Dict[str, Any], table: torch.Tensor,
                       pos: torch.Tensor) -> Dict[str, Any]:
    """Assemble every slot's contiguous cache from its pages.

    Returns ``{"pos": (rows,), "g*": {"k"/"v": (NG, rows, C, K, hd)}}``
    with ``rows`` the slots of every lane, lane-major, and ``C =
    pages_per_seq * page_size`` — the batch cache ``DecoderLM.decode_step``
    consumes with per-row positions.  Rows at positions >= ``pos`` are
    zeroed: they are either unwritten or trash-page garbage, and zeroing
    them makes the gathered cache a function of the decode history alone
    (the same bits in every execution mode, whatever order duplicate
    writes reached the trash page in).
    """
    pp = table.shape[-1]
    pos = pos.reshape(-1)
    rows = pos.shape[0]
    out: Dict[str, Any] = {"pos": pos}

    def one(leaf):
        pool, ids = _page_rows(leaf, table)
        ps = leaf.shape[-3]
        x = pool.index_select(1, ids)              # (NG, rows * PP, ps, ...)
        x = x.reshape((x.shape[0], rows, pp * ps) + tuple(x.shape[3:]))
        idx = torch.arange(pp * ps, device=pos.device)
        stale = idx[None, :] >= pos[:, None]       # (rows, C)
        return x.masked_fill_(stale[None, :, :, None, None], 0)

    for g, kv in pages.items():
        out[g] = tree_map(one, kv)
    return out


def _write_slot_caches(pages: Dict[str, Any], table: torch.Tensor,
                      caches: Dict[str, Any]) -> Dict[str, Any]:
    """Write gather-layout caches back into their pages, in place.  Live
    slots own disjoint pages, so the write is order-free there; duplicate
    writes only ever land on the trash page, whose content is never read
    unmasked (see :func:`gather_slot_caches`)."""

    def one(leaf, x):
        pool, ids = _page_rows(leaf, table)
        ps = leaf.shape[-3]
        x = x.reshape((x.shape[0], ids.shape[0], ps) + tuple(x.shape[3:]))
        pool.index_copy_(1, ids, x)
        return leaf

    return {g: tree_map(one, kv, caches[g]) for g, kv in pages.items()}


def written_rows(cache: Dict[str, Any]) -> Dict[str, Any]:
    """Every row's cache entry at ``min(pos, C - 1)`` — the one row
    ``DecoderLM.decode_step`` writes — copied before the step, for
    :func:`scatter_slot_caches` to restore.  ``cache`` is gather-layout
    (:func:`gather_slot_caches`)."""
    pos = cache["pos"].reshape(-1)
    slots = torch.arange(pos.shape[0], device=pos.device)

    def one(x):
        return x[:, slots, torch.clamp(pos, max=x.shape[2] - 1).long()
                 ].clone()

    out: Dict[str, Any] = {"pos": pos}
    for g, kv in cache.items():
        if g != "pos":
            out[g] = tree_map(one, kv)
    return out


def scatter_slot_caches(pages: Dict[str, Any], table: torch.Tensor,
                        new: Dict[str, Any], kept: Dict[str, Any],
                        select: torch.Tensor) -> Dict[str, Any]:
    """Write every slot's cache back into its pages, in place: slot ``s``
    writes ``new`` where ``select[s]``, else its cache from before the
    step.  ``new`` is the gather-layout cache ``decode_step`` updated in
    place, and ``kept`` the rows it wrote, from :func:`written_rows`
    before the step: restoring them in ``new`` (in place) gives the old
    cache, so this is the JAX package's ``where(select, new, old)`` over
    whole caches at the cost of one row a slot."""
    pos = kept["pos"]
    slots = torch.arange(pos.shape[0], device=pos.device)
    stay = ~select.reshape(1, -1, 1, 1)

    def restore(x, old):
        row = torch.clamp(pos, max=x.shape[2] - 1).long()
        x[:, slots, row] = torch.where(stay, old, x[:, slots, row])
        return x

    return _write_slot_caches(pages, table, {
        g: tree_map(restore, new[g], kept[g]) for g in pages})


# ---------------------------------------------------------------------------
# Host-facing conversions (the kv_cache.py helpers, used for real)
# ---------------------------------------------------------------------------


def cache_to_pages(cache: Pytree, page_size: int) -> Pytree:
    """Split a batch-1 model cache into page-major tensors.

    Pads the sequence axis up to a page multiple first (via
    :func:`~repro_torch.serve.kv_cache.pad_cache` — zero rows are masked
    by position on read), then reshapes each ``(NG, 1, C, K, hd)`` leaf to
    ``(P, NG, page_size, K, hd)``.  Inverse of :func:`pages_to_cache`.
    """
    leaves = [x for g, kv in cache.items() if g != "pos"
              for x in (kv.values() if isinstance(kv, dict) else [kv])]
    if not leaves:
        raise PagedKVError("cache has no k/v leaves to page")
    C = leaves[0].shape[2]
    target = pages_for(C, page_size) * int(page_size)
    padded = pad_cache(cache, target)

    def split(x):  # (NG, 1, C', K, hd) -> (P, NG, page_size, K, hd)
        y = x[:, 0]
        y = y.reshape((x.shape[0], -1, int(page_size)) + tuple(y.shape[2:]))
        return y.movedim(1, 0).contiguous()

    return {g: tree_map(split, kv)
            for g, kv in padded.items() if g != "pos"}


def pages_to_cache(paged: Pytree, pos) -> Pytree:
    """Reassemble a batch-1 model cache from page-major tensors."""

    def join(x):  # (P, NG, page_size, K, hd) -> (NG, 1, C, K, hd)
        y = x.movedim(0, 1)
        y = y.reshape((y.shape[0], y.shape[1] * y.shape[2])
                      + tuple(y.shape[3:]))
        return y[:, None]

    out = {g: tree_map(join, kv) for g, kv in paged.items()}
    out["pos"] = int(pos)
    return out


def pool_token_count(pages: Dict[str, Any], owner, page_size: int) -> int:
    """KV token slots currently HELD by live pages of one lane's pool, in
    :func:`~repro_torch.serve.kv_cache.cache_tokens`' accounting
    convention (k and v counted once).  ``cache_tokens`` supplies the
    per-(batch, row) convention on a probe cache so the two counters
    cannot drift."""
    per_page = cache_tokens(pages_to_cache(
        tree_map(lambda x: x[:1], pages), 0))  # one page, batch 1
    held = int((torch.as_tensor(owner) >= 0).sum())
    del page_size  # the probe cache already encodes rows-per-page
    return held * per_page
