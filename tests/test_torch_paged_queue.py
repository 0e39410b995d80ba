"""The port's host paging (``repro_torch.core.queue.PagedQueue``) and its
module-level ``pop`` against the JAX package's (``repro.core.queue``):
seeded programs of pushes, pops and steals must leave the same host
pages, counters, ring, popped items and stolen sets; and the JAX suite's
cases (``tests/test_paged_queue.py``) hold for the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as jqueue
from repro_torch.core import ops as tops
from repro_torch.core import queue as tqueue
from repro_torch.core.queue import PagedQueue

from _torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
SPEC = torch.zeros((), dtype=torch.int32)
JSPEC = jax.ShapeDtypeStruct((), jnp.int32)


def _pair(cap, low_watermark=None, backend="reference"):
    return (jqueue.PagedQueue(cap, JSPEC, low_watermark=low_watermark,
                              backend="reference"),
            PagedQueue(cap, SPEC, low_watermark=low_watermark,
                       backend=backend, device=CPU))


def _same(jpq, tpq, what):
    assert len(jpq.pages) == len(tpq.pages), what
    for (jb, jn), (tb, tn) in zip(jpq.pages, tpq.pages):
        assert jn == tn, what
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy(),
                                      err_msg=what)
    for attr in ("spills", "spilled_items", "refills", "refilled_items",
                 "_net_in"):
        assert getattr(jpq, attr) == getattr(tpq, attr), (what, attr)
    assert int(jpq.state.lo) == int(tpq.state.lo), what
    assert int(jpq.state.size) == int(tpq.state.size), what
    np.testing.assert_array_equal(np.asarray(jpq.state.buf),
                                  tpq.state.buf.numpy(), err_msg=what)
    assert jpq.total_size() == tpq.total_size() == len(tpq), what


@pytest.mark.parametrize("backend", ["reference", "cuda", "relaxed"])
@pytest.mark.parametrize("seed", range(3))
def test_seeded_programs_match_the_jax_package(seed, backend):
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([8, 16]))
    wm = [None, 2, cap // 2][seed % 3]
    jpq, tpq = _pair(cap, wm, backend)
    nxt, popped, stolen, pushed = 1, [], [], []
    for step in range(60):
        op = rng.choice(["push", "push", "pop", "pop", "steal"])
        what = f"seed {seed} step {step} {op}"
        if op == "push":
            k = int(rng.integers(1, 2 * cap + 2))
            ids = np.arange(nxt, nxt + k, dtype=np.int32)
            nxt += k
            pushed.extend(ids.tolist())
            jpq.push(jnp.asarray(ids), k)
            tpq.push(torch.from_numpy(ids), k)
        elif op == "pop":
            j_item, j_ok = jpq.pop()
            t_item, t_ok = tpq.pop()
            assert j_ok == t_ok, what
            if t_ok:
                assert int(j_item) == int(t_item), what
                popped.append(int(t_item))
        else:
            p = float(rng.choice([0.1, 0.25, 0.5, 0.75, 1.0]))
            j_got, t_got = jpq.steal_bulk(p), tpq.steal_bulk(p)
            assert j_got == t_got, what
            stolen.extend(t_got)
        _same(jpq, tpq, what)
    rest = []
    while (item := tpq.pop_item()) is not None:
        rest.append(item)
    assert sorted(popped + stolen + rest) == pushed  # every id once


def test_module_level_pop_matches_the_jax_package():
    rng = np.random.default_rng(5)
    buf = rng.integers(1, 100, (3, 8)).astype(np.int32)
    lo = np.array([0, 5, 7], np.int32)
    size = np.array([0, 4, 8], np.int32)
    tq, t_item, t_ok = tqueue.pop(tops.QueueState(torch.from_numpy(buf),
                                                  torch.from_numpy(lo),
                                                  torch.from_numpy(size)))
    for l in range(3):
        jq, j_item, j_ok = jqueue.pop(jqueue.QueueState(
            jnp.asarray(buf[l]), jnp.int32(lo[l]), jnp.int32(size[l])))
        assert bool(j_ok) == bool(t_ok[l]) and int(jq.size) == int(tq.size[l])
        if bool(j_ok):
            assert int(j_item) == int(t_item[l])


def _pop_all(pq):
    out = []
    while (item := pq.pop_item()) is not None:
        out.append(item)
    return out


def test_spill_then_drain_preserves_all_items():
    jpq, tpq = _pair(8, 2)
    pushed = []
    for base in range(0, 40, 5):
        vals = np.arange(base, base + 5, dtype=np.int32)
        jpq.push(jnp.asarray(vals), 5)
        tpq.push(torch.from_numpy(vals), 5)
        pushed.extend(vals.tolist())
        _same(jpq, tpq, f"push {base}")
    assert tpq.pages, "overflow must have spilled to host pages"
    got = _pop_all(tpq)
    assert got == _pop_all(jpq)
    assert sorted(got) == sorted(pushed) and tpq.total_size() == 0


def test_spill_on_nearly_empty_ring_never_oversteals():
    """The spill proportion is capped at 1.0: a ring holding fewer than
    the spill size spills what it has, never more."""
    jpq, tpq = _pair(16)
    for vals in (np.arange(4, dtype=np.int32),
                 np.arange(100, 113, dtype=np.int32)):
        jpq.push(jnp.asarray(vals), len(vals))
        tpq.push(torch.from_numpy(vals), len(vals))
        _same(jpq, tpq, f"push {len(vals)}")
    assert int(tpq.state.size) >= 0 and tpq.total_size() == 17
    assert sorted(_pop_all(tpq)) == list(range(4)) + list(range(100, 113))


def test_low_watermark_boundary_triggers_refill_exactly():
    tpq = PagedQueue(8, SPEC, low_watermark=2, backend="cuda", device=CPU)
    tpq.pages.append((torch.arange(100, 103, dtype=torch.int32), 3))
    tpq._net_in += 3
    tpq.push(torch.tensor([1, 2, 3, 4], dtype=torch.int32), 4)
    for _ in range(2):  # size 4, then 3 > watermark: no refill yet
        _, valid = tpq.pop()
        assert valid and len(tpq.pages) == 1
    _, valid = tpq.pop()  # size == watermark: the page comes back first
    assert valid and not tpq.pages and tpq.refills == 1
    assert int(tpq.state.size) >= 3


def test_partial_refill_keeps_the_rest_as_a_page():
    """A page larger than the ring's free space: the un-spliced tail stays
    a host page (the JAX package's refill fix)."""
    jpq, tpq = _pair(8, 6)
    for pq, page in ((jpq, np.arange(50, 58, dtype=np.int32)),
                     (tpq, torch.arange(50, 58, dtype=torch.int32))):
        pq.pages.append((page, 8))
        pq._net_in += 8
        pq.push(pq.make_batch(range(1, 7))[0], 6)
        pq.pop()
    _same(jpq, tpq, "partial refill")
    assert tpq.refills == 1 and tpq.refilled_items == 2
    assert tpq.pages[0][1] == 6 and tpq.total_size() == 13


def test_refill_after_steal_empties_device_ring():
    jpq, tpq = _pair(8, 2)
    for base in range(0, 24, 4):
        vals = np.arange(base, base + 4, dtype=np.int32)
        jpq.push(jnp.asarray(vals), 4)
        tpq.push(torch.from_numpy(vals), 4)
    got = tpq.steal(1.0)
    j_got = jpq.steal(1.0)
    assert [n for _, n in got] == [n for _, n in j_got] and got
    remaining = tpq.total_size()
    out = _pop_all(tpq)
    assert len(out) == remaining and tpq.total_size() == 0 and not tpq.pages


def test_push_larger_than_one_page():
    jpq, tpq = _pair(8, 2)
    vals = np.arange(20, dtype=np.int32)
    jpq.push(jnp.asarray(vals), 20)
    tpq.push(torch.from_numpy(vals), 20)
    _same(jpq, tpq, "push 20")
    assert tpq.pages and sorted(_pop_all(tpq)) == vals.tolist()


def test_steal_respects_queue_limit_on_device_ring():
    tpq = PagedQueue(8, SPEC, low_watermark=0, backend="cuda", device=CPU)
    tpq.push_bulk([7])  # below the paper's queue limit
    assert tpq.steal(1.0) == [] and tpq.total_size() == 1
    assert tpq.pop_item() == 7 and tpq.pop_item() is None


def test_host_queue_adapters_and_default_device(monkeypatch):
    tpq = PagedQueue(8, SPEC, backend="cuda", device=CPU)
    tpq.push_batch(tpq.make_batch([]))  # nothing to push
    tpq.push_bulk(range(1, 20))
    assert len(tpq) == 19 and tpq.spills > 0
    assert sorted(tpq.steal_bulk(0.5) + _pop_all(tpq)) == list(range(1, 20))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedQueue(8, SPEC)


def test_python_float_and_float32_proportions_follow_the_jax_paths():
    """The JAX package's pure steal takes ``1 - p`` of a Python float in
    float64 and rounds it (3 items at p = 1/3: 1 stolen); its donating,
    jitted steal rounds ``p`` to float32 first (2 stolen).  The port's
    steal does the first for a Python float and the second for a float32
    tensor, and ``PagedQueue`` passes float32 tensors, as the JAX
    ``PagedQueue`` donates."""
    from repro.core import ops as jops

    def jq():
        return jops.QueueState(jnp.arange(1, 9, dtype=jnp.int32),
                               jnp.int32(0), jnp.int32(3))

    tq = tops.QueueState(torch.arange(1, 9, dtype=torch.int32),
                         torch.tensor(0, dtype=torch.int32),
                         torch.tensor(3, dtype=torch.int32))
    jref, tref = jops.make_ops("reference"), tops.make_ops("reference")
    kw = dict(max_steal=8, queue_limit=0)
    assert int(jref.steal(jq(), 1 / 3, **kw)[2]) == 1
    assert int(jref.steal(jq(), 1 / 3, donate=True, **kw)[2]) == 2
    assert int(tref.steal(tq, 1 / 3, **kw)[2]) == 1
    assert int(tref.steal(tq, tops.f32_scalar(1 / 3, CPU), **kw)[2]) == 2


# The port's backend -> the JAX backend of the same routing it is held to
# (the port's "cuda" is the JAX package's kernel routing, "auto" there).
_C6_BACKENDS = {"reference": "reference", "cuda": "auto", "auto": "auto",
                "relaxed": "relaxed"}


def _c6_programs():
    """The ring of the reproduction (8 rows, size 3) and seeded rings of
    64 rows at sizes 0-64, each with its lo."""
    yield np.arange(1, 9, dtype=np.int32), 0, 3
    rng = np.random.default_rng(6)
    for size in range(65):
        ring = rng.integers(1, 1 << 20, 64).astype(np.int32)
        yield ring, int(rng.integers(0, 64)), size


@pytest.mark.parametrize("backend", [*_C6_BACKENDS, "check"])
def test_donated_steal_rounds_a_python_float_as_the_jax_jit_does(backend):
    """With ``donate=True`` the JAX package's steal is jitted, which traces
    a Python-float proportion as float32, so ``1 - p`` is a float32
    subtraction (3 items at p = 1/3: 2 stolen); without it the pure path
    rounds ``1 - p`` from float64 (1 stolen).  Every port backend follows
    both paths for a Python float and for a float32 tensor; the checked
    backend (whose mirror must follow the op it wraps) is held to the
    port's unchecked one."""
    from repro.core import ops as jops
    import repro.core  # noqa: F401  (registers the JAX relaxed backend)

    if backend == "check":
        ops = tops.make_ops("cuda", capacity=64, max_steal=64, check=True)
        want_ops, jax_ops = tops.make_ops("cuda"), None
    else:
        ops = tops.make_ops(backend, capacity=64, max_steal=64)
        jax_ops = jops.make_ops(_C6_BACKENDS[backend], capacity=64,
                                max_push=64, max_steal=64)
    counts = {}
    for ring, lo, size in _c6_programs():
        cap = ring.shape[0]
        for p in (1 / 3, 0.1, 0.9, 0.7):
            for donate in (False, True):
                for as_tensor in (False, True):
                    tq = tops.QueueState(torch.from_numpy(ring.copy()),
                                         torch.tensor(lo, dtype=torch.int32),
                                         torch.tensor(size,
                                                      dtype=torch.int32))
                    tp = tops.f32_scalar(p, CPU) if as_tensor else p
                    kw = dict(max_steal=cap, queue_limit=0, donate=donate)
                    q2, batch, n = ops.steal(tq, tp, **kw)
                    if jax_ops is None:
                        wq, wbatch, wn = want_ops.steal(
                            tops.QueueState(torch.from_numpy(ring.copy()),
                                            torch.tensor(lo,
                                                         dtype=torch.int32),
                                            torch.tensor(size,
                                                         dtype=torch.int32)),
                            tp, **kw)
                        want = (int(wn), int(wq.lo), wbatch.numpy())
                    else:
                        jq = jops.QueueState(jnp.asarray(ring),
                                             jnp.int32(lo), jnp.int32(size))
                        jp = jnp.float32(p) if as_tensor else p
                        jq2, jbatch, jn = jax_ops.steal(jq, jp, **kw)
                        want = (int(jn), int(jq2.lo), np.asarray(jbatch))
                    what = (backend, size, p, donate, as_tensor)
                    assert int(n) == want[0], what
                    assert int(q2.lo) == want[1], what
                    assert int(q2.size) == size - want[0], what
                    np.testing.assert_array_equal(batch.numpy(), want[2],
                                                  err_msg=str(what))
                    np.testing.assert_array_equal(q2.buf.numpy(), ring,
                                                  err_msg=str(what))
                    counts[(cap, size, p, donate, as_tensor)] = int(n)
    # the reproduction: 1 stolen without donation, 2 with it (a Python
    # float), 2 either way from a float32 tensor
    assert [counts[(8, 3, 1 / 3, d, t)] for d in (False, True)
            for t in (False, True)] == [1, 2, 2, 2]
