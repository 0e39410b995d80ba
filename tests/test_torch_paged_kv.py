"""The port's paged KV pool (``repro_torch.serve.paged_kv``) and the model's
per-row decode positions against the JAX package on the CPU.

The allocator, the page release and the gather / scatter run on seeded
masks and pools in both packages: integers must be equal and pages equal
bit for bit.  The port's gather returns the batched layout its
``DecoderLM.decode_step`` consumes (``(NG, rows, C, K, hd)``), the JAX
package's the per-slot batch-1 caches ``jax.vmap`` consumes (``(S, NG, 1,
C, K, hd)``); they are compared after a transpose.  The per-row decode
(``cache["pos"]`` a ``(B,)`` tensor) is held to ``jax.vmap`` of the JAX
package's ``decode_step`` over batch-1 caches, at the decode tolerance of
``tests/test_torch_models.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jax_build_model
from repro.serve import paged_kv as J
from repro_torch import configs
from repro_torch.models.zoo import build_model, params_from_numpy
from repro_torch.serve import paged_kv as T

from _torch_parity import assert_same, tree_np, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
S, PP, P, PS = 5, 4, 9, 4          # slots, pages a sequence, pool pages, rows


def _models(arch="llama3.2-1b", compute_dtype="float32"):
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get(arch)),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(configs.reduced(configs.get(arch)),
                               compute_dtype=compute_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, params_from_numpy(tree_np(jp), CPU)


def _state(seed: int):
    """A seeded allocator state of one lane: owner vector with free pages
    and owners among the slots, the owned pages in each owner's table row,
    needs, page columns and current grants."""
    rng = np.random.default_rng(seed)
    owner = np.where(rng.random(P) < 0.45, -1,
                     rng.integers(0, S, P)).astype(np.int32)
    table = np.full((S, PP), P, np.int32)
    n_alloc = np.zeros(S, np.int32)
    for page in np.where(owner >= 0)[0]:
        s = owner[page]
        if n_alloc[s] < PP:
            table[s, n_alloc[s]] = page
            n_alloc[s] += 1
        else:
            owner[page] = -1
    need = rng.random(S) < 0.6
    page_idx = np.minimum(n_alloc, PP - 1 + (seed % 2)).astype(np.int32)
    retire = rng.random(S) < 0.4
    return dict(table=table, owner=owner, n_alloc=n_alloc, need=need,
                page_idx=page_idx, retire=retire)


def _t(a):
    return torch.from_numpy(np.array(a))


SEEDS = range(6)


@pytest.mark.parametrize("seed", SEEDS)
def test_alloc_pages_matches(seed):
    st = _state(seed)
    args = [st[k] for k in ("table", "owner", "n_alloc", "need", "page_idx")]
    want = J.alloc_pages(*map(jnp.asarray, args))
    got = T.alloc_pages(*map(_t, args))
    for name, w, g in zip(("table", "owner", "n_alloc"), want, got):
        assert g.dtype == torch.int32, name
        assert_same(np.asarray(w), g, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_free_pages_matches(seed):
    st = _state(seed)
    args = [st[k] for k in ("table", "owner", "n_alloc", "retire")]
    want = J.free_pages(*map(jnp.asarray, args))
    got = T.free_pages(*map(_t, args))
    for name, w, g in zip(("table", "owner", "n_alloc"), want, got):
        assert_same(np.asarray(w), g, name)


def test_allocator_on_stacked_lanes_is_each_lanes_own():
    """The port's lane axis: one call over three stacked lanes gives each
    lane what the JAX package gives it alone."""
    lanes = [_state(seed) for seed in (10, 11, 12)]

    def stack(k):
        return _t(np.stack([st[k] for st in lanes]))

    alloc = T.alloc_pages(*(stack(k) for k in ("table", "owner", "n_alloc",
                                               "need", "page_idx")))
    free = T.free_pages(*(stack(k) for k in ("table", "owner", "n_alloc",
                                             "retire")))
    for i, st in enumerate(lanes):
        want = J.alloc_pages(*(jnp.asarray(st[k]) for k in (
            "table", "owner", "n_alloc", "need", "page_idx")))
        for w, g in zip(want, alloc):
            assert_same(np.asarray(w), g[i], f"alloc lane {i}")
        want = J.free_pages(*(jnp.asarray(st[k]) for k in (
            "table", "owner", "n_alloc", "retire")))
        for w, g in zip(want, free):
            assert_same(np.asarray(w), g[i], f"free lane {i}")


def _pool(rng, dtype, lanes=None):
    """Random pool leaves ``(P + 1, NG, ps, K, hd)`` for one layer group
    (NaN in the trash page: a gather must not let it through)."""
    shape = ((lanes,) if lanes else ()) + (P + 1, 2, PS, 2, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., P, :, :, :, :] = np.nan
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return {"g0": {"k": t, "v": t * 2}}


def _jax_pages(pages):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(
        t.float().numpy()).astype(jnp.dtype(str(t.dtype).split(".")[1])),
        pages)


def _live_table(seed):
    """Each slot's allocated pages (disjoint), the rest trash; positions
    inside or at the edge of the allocation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(P)
    n_alloc = rng.integers(0, 3, S)
    table = np.full((S, PP), P, np.int32)
    at = 0
    for s in range(S):
        table[s, :n_alloc[s]] = perm[at:at + n_alloc[s]]
        at += n_alloc[s]
    pos = np.minimum(n_alloc * PS - rng.integers(0, PS, S), PP * PS)
    return table, np.maximum(pos, 0).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_slot_caches_matches(dtype, seed):
    rng = np.random.default_rng(seed)
    pages = _pool(rng, dtype)
    table, pos = _live_table(seed)
    want = J.gather_slot_caches(_jax_pages(pages), jnp.asarray(table),
                                jnp.asarray(pos))
    got = T.gather_slot_caches(pages, _t(table), _t(pos))
    assert_same(np.asarray(want["pos"]), got["pos"], "pos")
    for kv in ("k", "v"):
        mine = got["g0"][kv]                       # (NG, S, C, K, hd)
        assert tuple(mine.shape) == (2, S, PP * PS, 2, 8)
        theirs = np.asarray(want["g0"][kv])[:, :, 0]   # (S, NG, C, K, hd)
        assert_same(np.swapaxes(theirs, 0, 1), mine, kv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_slot_caches_matches(dtype):
    """A decode step's write-back: every slot's cache changed only at its
    row min(pos, C - 1), as decode_step changes it, and written back
    where selected, else restored.  Every page but the trash page equal
    to the JAX package's whole-cache scatter bit for bit (duplicate
    writes land only there, in an order neither package fixes)."""
    rng = np.random.default_rng(7)
    pages = _pool(rng, dtype)
    table, pos = _live_table(7)
    old = T.gather_slot_caches(pages, _t(table), _t(pos))
    kept = T.written_rows(old)
    new = {"pos": old["pos"], "g0": {kv: x.clone()
                                     for kv, x in old["g0"].items()}}
    row = torch.clamp(old["pos"], max=PP * PS - 1).long()
    for x in new["g0"].values():
        x[:, torch.arange(S), row] = torch.from_numpy(rng.standard_normal(
            (x.shape[0], S) + tuple(x.shape[3:])).astype(np.float32)
        ).to(x.dtype)
    select = rng.random(S) < 0.5

    def jax_layout(c):
        return {"g0": jax.tree_util.tree_map(
            lambda t: jnp.asarray(np.swapaxes(
                t.float().numpy(), 0, 1)[:, :, None]).astype(
                jnp.dtype(dtype)), c["g0"])}

    want = J.scatter_slot_caches(_jax_pages(pages), jnp.asarray(table),
                                 jax_layout(old), jax_layout(new),
                                 jnp.asarray(select))
    got = T.scatter_slot_caches(
        {"g0": {kv: x.clone() for kv, x in pages["g0"].items()}},
        _t(table), new, kept, _t(select))
    for kv in ("k", "v"):
        assert_same(np.asarray(want["g0"][kv])[:P], got["g0"][kv][:P], kv)
        # unselected slots' caches are the old ones again
        assert torch.equal(new["g0"][kv][:, ~torch.from_numpy(select)],
                           old["g0"][kv][:, ~torch.from_numpy(select)])


def test_gather_and_scatter_on_stacked_lanes():
    """Lane-major rows over two stacked pools, each lane's pages its own."""
    rng = np.random.default_rng(3)
    pages = _pool(rng, "float32", lanes=2)
    tables, poss = zip(*(_live_table(s) for s in (3, 4)))
    table, pos = _t(np.stack(tables)), _t(np.stack(poss))
    got = T.gather_slot_caches(pages, table, pos)
    for i in range(2):
        one = T.gather_slot_caches({"g0": {kv: x[i] for kv, x in
                                           pages["g0"].items()}},
                                   table[i], pos[i])
        for kv in ("k", "v"):
            assert_same(one["g0"][kv], got["g0"][kv][:, i * S:(i + 1) * S],
                        kv)
    before = {kv: x.clone() for kv, x in pages["g0"].items()}
    T.scatter_slot_caches(pages, table, got, T.written_rows(got),
                          torch.ones(2 * S, dtype=torch.bool))
    for kv in ("k", "v"):   # written back where live, rows >= pos zeroed
        for i in range(2):
            for s in range(S):
                for j, page in enumerate(tables[i][s]):
                    if page == P:
                        continue
                    rows = slice(j * PS, (j + 1) * PS)
                    want = before[kv][i, page].clone()
                    stale = torch.arange(j * PS, (j + 1) * PS) >= poss[i][s]
                    want[:, stale] = 0
                    assert torch.equal(pages["g0"][kv][i, page], want)
                    assert torch.equal(
                        got["g0"][kv][:, i * S + s, rows], want)


def test_cache_pages_round_trip_and_token_count_match():
    jm, tm, jp, tp = _models()
    toks = np.random.default_rng(2).integers(1, 512, (1, 7)).astype(np.int32)
    _, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tcache = params_from_numpy(tree_np({k: v for k, v in jcache.items()
                                        if k != "pos"}), CPU)
    tcache["pos"] = 7
    jpages, tpages = J.cache_to_pages(jcache, 4), T.cache_to_pages(tcache, 4)
    for kv in ("k", "v"):
        assert_same(np.asarray(jpages["g0"][kv]), tpages["g0"][kv], kv)
    jback, tback = J.pages_to_cache(jpages, 7), T.pages_to_cache(tpages, 7)
    assert tback["pos"] == int(jback["pos"]) == 7
    for kv in ("k", "v"):
        assert_same(np.asarray(jback["g0"][kv]), tback["g0"][kv], kv)
    jpool = J.make_pool(jm, n_slots=S, n_pages=P, page_size=PS,
                        pages_per_seq=PP)
    tpool = T.make_pool(tm, n_slots=S, n_pages=P, page_size=PS,
                        pages_per_seq=PP, device="cpu")
    for name in ("table", "owner"):
        assert_same(np.asarray(jpool[name]), tpool[name], name)
    for kv in ("k", "v"):
        assert tuple(tpool["pages"]["g0"][kv].shape) == \
            jpool["pages"]["g0"][kv].shape
        assert tpool["pages"]["g0"][kv].dtype == tm.cdtype
    owner = np.array([0, -1, 2, 2, -1, 1, -1, -1, 4], np.int32)
    assert T.pool_token_count(tpool["pages"], owner, PS) == \
        J.pool_token_count(jpool["pages"], jnp.asarray(owner), PS) == 5 * PS
    assert T.pages_for(13, 4) == J.pages_for(13, 4) == 4


def test_windowed_layers_are_refused():
    _, tm, _, _ = _models("gemma2-9b")
    with pytest.raises(T.PagedKVError, match="ring"):
        T.make_pool(tm, n_slots=2, n_pages=4, page_size=16,
                    pages_per_seq=2, device="cpu")
    cache = tm.make_cache(2, 16, device="cpu")
    cache["pos"] = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="per-row positions"):
        tm.decode_step(build_model(tm.cfg).init(
            torch.Generator().manual_seed(0)), cache,
            torch.ones((2, 1), dtype=torch.int32))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_per_row_decode_matches_vmapped_jax(compute_dtype):
    """Rows at positions 0, 3, 11, C - 1 and C (written at C - 1): logits
    within the decode tolerance, every row's cache written at its own
    row, no host read of the positions."""
    jm, tm, jp, tp = _models(compute_dtype=compute_dtype)
    tol = 1e-4 if compute_dtype == "float32" else 2e-2
    C, B = 16, 5
    rng = np.random.default_rng(5)
    pos = np.array([0, 3, 11, C - 1, C], np.int32)
    base = tm.make_cache(B, C, device="cpu")
    for kv in ("k", "v"):
        x = rng.standard_normal(tuple(base["g0"][kv].shape)).astype(
            np.float32)
        x[:, np.arange(C)[None, :] >= pos[:, None]] = 0
        base["g0"][kv] = torch.from_numpy(x).to(tm.cdtype)
    toks = rng.integers(1, 512, (B, 1)).astype(np.int32)

    jcache = {"pos": jnp.asarray(pos), "g0": {
        kv: jnp.asarray(np.swapaxes(base["g0"][kv].float().numpy(), 0, 1)
                        [:, :, None]).astype(jm.cdtype) for kv in ("k", "v")}}
    jl, jnew = jax.vmap(lambda c, t: jm.decode_step(jp, c, t))(
        jcache, jnp.asarray(toks)[:, None])
    mine = {"pos": torch.from_numpy(pos), "g0": {
        kv: x.clone() for kv, x in base["g0"].items()}}
    tl, tnew = tm.decode_step(tp, mine, torch.from_numpy(toks))
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, 0], atol=tol,
                               rtol=tol)
    assert tnew["pos"].tolist() == (pos + 1).tolist()
    for kv in ("k", "v"):
        theirs = np.swapaxes(np.asarray(jnew["g0"][kv].astype(jnp.float32))
                             [:, :, 0], 0, 1)
        np.testing.assert_allclose(tnew["g0"][kv].float().numpy(), theirs,
                                   atol=tol, rtol=tol)
        # rows other than min(pos, C - 1) are untouched
        changed = (tnew["g0"][kv] != base["g0"][kv]).any(-1).any(-1)
        for b in range(B):
            rows = torch.nonzero(changed[:, b].any(0)).flatten().tolist()
            assert rows == [min(int(pos[b]), C - 1)], (b, rows)
