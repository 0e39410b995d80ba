"""The port's ring kernels K1-K4.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold it against the JAX package's Pallas kernel in interpret mode on
the same seeded inputs, exactly (bitwise for float and bfloat16 payloads).
The CUDA kernels themselves are held against their plain versions by
``tests/test_torch_cuda.py`` on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.queue_push.kernel import (ring_scatter_supported,
                                             ring_slice_supported)
from repro.kernels.queue_push.ops import pop_slice as jax_pop_slice
from repro.kernels.queue_push.ops import push_scatter as jax_push_scatter
from repro.kernels.queue_push.ref import ring_scatter_ref as jax_scatter_ref
from repro.kernels.queue_steal.kernel import ring_gather_supported
from repro.kernels.queue_steal.ops import steal_gather as jax_steal_gather
from repro.kernels.queue_transfer.kernel import ring_transfer_supported
from repro.kernels.queue_transfer.ops import \
    transfer_splice as jax_transfer_splice
from repro.kernels.queue_transfer.ref import ring_transfer_ref as \
    jax_transfer_ref
from repro_torch.kernels import _lib
from repro_torch.kernels import cases as C
from repro_torch.kernels.dd_expand.ops import expand_layer_bulk, expand_pool
from repro_torch.kernels.queue_push.ops import (pop_slice, push_scatter,
                                                ring_scatter)
from repro_torch.kernels.queue_push.ref import ring_scatter_ref
from repro_torch.kernels.queue_steal.ops import ring_gather, steal_gather
from repro_torch.kernels.queue_transfer.ops import transfer_splice
from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref
from repro_torch.kernels.ssd_scan.ops import ssd

from _torch_parity import assert_same, jax_payload

CPU = torch.device("cpu")
I32 = torch.int32


def _vec(*xs):
    return torch.tensor(xs, dtype=I32)


def _both(rng, shape, dtype):
    a = C.payload(rng, shape, dtype)
    return jax_payload(a, dtype), C.to_tensor(a, dtype, CPU)


@pytest.mark.parametrize("case", C.STEAL_CASES)
def test_ring_gather_plain_matches_pallas(case):
    cap, d, max_steal, lo, n, dtype = case
    jbuf, tbuf = _both(np.random.default_rng(0), (cap, d), dtype)
    want = jax_steal_gather(jbuf, jnp.int32(lo), jnp.int32(n),
                            max_steal=max_steal, interpret=True)
    got = steal_gather(tbuf[None], _vec(lo), _vec(n), max_steal=max_steal)
    assert_same(want, got[0], f"ring_gather {case}")


@pytest.mark.parametrize("case", C.SCATTER_CASES)
def test_ring_scatter_plain_matches_pallas(case):
    cap, d, max_push, start, n, dtype = case
    assert ring_scatter_supported(cap, max_push)
    rng = np.random.default_rng(1)
    jbuf, tbuf = _both(rng, (cap, d), dtype)
    jbatch, tbatch = _both(rng, (max_push, d), dtype)
    want = jax_push_scatter(jbuf, jbatch, jnp.int32(start), jnp.int32(n),
                            interpret=True)
    ring = tbuf[None].clone()
    out = push_scatter(ring, tbatch[None], _vec(start), _vec(n))
    assert out is ring  # the splice is in place
    assert_same(want, ring[0], f"ring_scatter {case}")


@pytest.mark.parametrize("case", C.SLICE_CASES)
def test_ring_slice_plain_matches_pallas(case):
    cap, d, max_n, lo, size, n, dtype = case
    assert ring_slice_supported(cap, max_n)
    jbuf, tbuf = _both(np.random.default_rng(2), (cap, d), dtype)
    want = jax_pop_slice(jbuf, jnp.int32(lo), jnp.int32(size), jnp.int32(n),
                         max_n=max_n, interpret=True)
    got = pop_slice(tbuf[None], _vec(lo), _vec(size), _vec(n), max_n=max_n)
    assert_same(want, got[0], f"ring_slice {case}")


@pytest.mark.parametrize("case", C.TRANSFER_CASES)
def test_ring_transfer_plain_matches_pallas(case):
    cap, d, lanes, max_steal, head, src_row, n, dtype = case
    rng = np.random.default_rng(3)
    jbuf, tbuf = _both(rng, (cap, d), dtype)
    jg, tg = _both(rng, (lanes, max_steal, d), dtype)
    want = jax_transfer_splice(jbuf, jg, jnp.int32(head), jnp.int32(src_row),
                               jnp.int32(n), max_steal=max_steal,
                               interpret=True)
    ring = tbuf[None].clone()
    transfer_splice(ring, tg, _vec(head), _vec(src_row), _vec(n),
                    max_steal=max_steal)
    assert_same(want, ring[0], f"ring_transfer {case}")


def test_queue_transfer_equals_select_then_push():
    """The fused transfer equals the two-step oracle — select the victim's
    window row, then ring-scatter it at the head — and the JAX kernel."""
    cap, d, lanes, max_steal = 512, 8, 4, 128
    rng = np.random.default_rng(4)
    jbuf, tbuf = _both(rng, (cap, d), "float32")
    jg, tg = _both(rng, (lanes, max_steal, d), "float32")
    for head, src_row, n in [(0, 0, 128), (450, 3, 100), (77, 2, 1)]:
        fused = tbuf[None].clone()
        transfer_splice(fused, tg, _vec(head), _vec(src_row), _vec(n),
                        max_steal=max_steal)
        two_step = ring_scatter_ref(tbuf[None], tg[src_row][None],
                                    _vec(head), _vec(n))
        assert torch.equal(fused, two_step)
        want = jax_transfer_splice(jbuf, jg, jnp.int32(head),
                                   jnp.int32(src_row), jnp.int32(n),
                                   max_steal=max_steal, interpret=True)
        assert_same(want, fused[0])
        assert_same(jax_scatter_ref(jbuf, jg[src_row], head, n), fused[0])


@pytest.mark.parametrize("kernel", ["gather", "scatter", "slice",
                                    "transfer"])
def test_one_launch_serves_every_lane(kernel):
    """Per-lane cursors: a stacked call equals the JAX kernel run lane by
    lane (wrapped, empty and full lanes mixed)."""
    rng = np.random.default_rng(5)
    lanes, cap, d, m = 5, 256, 3, 128
    jbuf, tbuf = _both(rng, (lanes, cap, d), "int32")
    lo = rng.integers(0, cap, lanes)
    n = np.array([0, m, 1, 77, m])
    if kernel == "gather":
        got = ring_gather(tbuf, _vec(*lo), _vec(*n), m)
        want = [jax_steal_gather(jbuf[l], jnp.int32(lo[l]), jnp.int32(n[l]),
                                 max_steal=m, interpret=True)
                for l in range(lanes)]
    elif kernel == "scatter":
        jb, tb = _both(rng, (lanes, m, d), "int32")
        got = ring_scatter(tbuf.clone(), tb, _vec(*lo), _vec(*n))
        want = [jax_push_scatter(jbuf[l], jb[l], jnp.int32(lo[l]),
                                 jnp.int32(n[l]), interpret=True)
                for l in range(lanes)]
    elif kernel == "slice":
        size = np.maximum(n, rng.integers(0, cap + 1, lanes))
        got = pop_slice(tbuf, _vec(*lo), _vec(*size), _vec(*n), max_n=m)
        want = [jax_pop_slice(jbuf[l], jnp.int32(lo[l]), jnp.int32(size[l]),
                              jnp.int32(n[l]), max_n=m, interpret=True)
                for l in range(lanes)]
    else:
        jg, tg = _both(rng, (lanes, m, d), "int32")
        src = rng.permutation(lanes)
        got = tbuf.clone()
        transfer_splice(got, tg, _vec(*lo), _vec(*src), _vec(*n),
                        max_steal=m)
        want = [jax_transfer_splice(jbuf[l], jg, jnp.int32(lo[l]),
                                    jnp.int32(src[l]), jnp.int32(n[l]),
                                    max_steal=m, interpret=True)
                for l in range(lanes)]
    for l in range(lanes):
        assert_same(want[l], got[l], f"{kernel} lane {l}")


@pytest.mark.parametrize("case", C.STEAL_BYTE_CASES)
def test_ring_gather_byte_rows_match_pallas(case):
    """K1's byte-path rows (every residue mod 16 bytes, 12-, 20- and 6-byte
    rows, segments ending at cap or mid-vector, n = 0 and cap, a segment
    lapping a ring smaller than max_steal): one stacked call against the
    JAX kernel in interpret mode, lane by lane."""
    cap, d, m, lo, n, dtype = case
    assert ring_gather_supported(cap, m)
    jbuf, tbuf = _both(np.random.default_rng(6), (len(lo), cap, d), dtype)
    got = steal_gather(tbuf, _vec(*lo), _vec(*n), max_steal=m)
    for l in range(len(lo)):
        want = jax_steal_gather(jbuf[l], jnp.int32(lo[l]), jnp.int32(n[l]),
                                max_steal=m, interpret=True)
        assert_same(want, got[l], f"ring_gather {case} lane {l}")


@pytest.mark.parametrize("case", C.TRANSFER_BYTE_CASES)
def test_ring_transfer_byte_rows_match_pallas(case):
    """K4's byte-path rows, lane by lane against the JAX kernel in
    interpret mode; where the Pallas kernel does not take the lane (n =
    cap needs max_steal = cap, past its geometry rule; a source row past
    the stack, which its index map wraps) against the JAX package's plain
    reference, whose clamp the port keeps; a negative source row, which
    that reference indexes from the end of the stack, likewise)."""
    cap, d, w, m, head, src, n, dtype = case
    rng = np.random.default_rng(7)
    jbuf, tbuf = _both(rng, (len(head), cap, d), dtype)
    jg, tg = _both(rng, (w, m, d), dtype)
    got = tbuf.clone()
    transfer_splice(got, tg, _vec(*head), _vec(*src), _vec(*n), max_steal=m)
    for l in range(len(head)):
        pallas = ring_transfer_supported(cap, m) and 0 <= src[l] < w
        want = jax_transfer_splice(jbuf[l], jg, jnp.int32(head[l]),
                                   jnp.int32(src[l]), jnp.int32(n[l]),
                                   max_steal=m, interpret=pallas)
        assert_same(want, got[l], f"ring_transfer {case} lane {l}")


def test_negative_src_row_counts_from_the_stack_end():
    """A source row in ``[-W, 0)`` reads window ``src_row + W``, as the JAX
    package's K4 reference indexes it: W 2, max_steal 4, a stack holding
    100-107, src_row -1 and n 3 splice 104, 105 and 106 at the head; a
    source row below ``-W`` raises."""
    stack = torch.arange(100, 108, dtype=I32)[:, None]      # (W * m, 1)
    buf = torch.zeros((1, 8, 1), dtype=I32)
    head, src_row, n, m = _vec(6), _vec(-1), _vec(3), 4
    got = ring_transfer_ref(buf, stack, head, src_row.long() * m, n)
    want = jax_transfer_ref(jnp.zeros((8, 1), jnp.int32),
                            jnp.arange(100, 108, dtype=jnp.int32)[:, None],
                            6, -4, 3)
    assert_same(want, got[0], "ring_transfer_ref, src_row -1")
    assert got[0, :, 0].tolist() == [106, 0, 0, 0, 0, 0, 104, 105]
    spliced = transfer_splice(buf.clone(), stack.view(2, 4, 1), head,
                              src_row, n, max_steal=m)
    assert torch.equal(spliced, got)
    with pytest.raises(ValueError, match="before the 8-row stack"):
        transfer_splice(buf.clone(), stack.view(2, 4, 1), head, _vec(-3), n,
                        max_steal=m)


def test_lane_with_nothing_to_splice_is_not_refused_for_its_src_row():
    """A source row below ``-W`` is refused only where rows are spliced: a
    lane with n = 0 reads nothing, so the wrapper and the plain version
    leave its ring as it was, and splice the other lanes as usual."""
    stack = torch.arange(100, 108, dtype=I32)[:, None]      # W 2, m 4
    buf = torch.zeros((2, 8, 1), dtype=I32)
    head, src_row, n, m = _vec(6, 0), _vec(-1, -3), _vec(3, 0), 4
    got = ring_transfer_ref(buf, stack, head, src_row.long() * m, n)
    assert got[0, :, 0].tolist() == [106, 0, 0, 0, 0, 0, 104, 105]
    assert not got[1].any()
    spliced = transfer_splice(buf.clone(), stack.view(2, 4, 1), head,
                              src_row, n, max_steal=m)
    assert torch.equal(spliced, got)
    with pytest.raises(IndexError):
        ring_transfer_ref(buf, stack, head, src_row.long() * m, _vec(3, 1))
    with pytest.raises(ValueError, match="src_row -3"):
        transfer_splice(buf.clone(), stack.view(2, 4, 1), head, src_row,
                        _vec(3, 1), max_steal=m)


@pytest.mark.parametrize("case", C.SCATTER_BYTE_CASES)
def test_ring_scatter_byte_rows_match_pallas(case):
    """K2's byte-path rows (every residue mod 16 bytes, 12-, 20- and 6-byte
    rows, pushes ending at cap, n = 0 and cap, n past a batch larger than
    the ring, negative starts and n): one stacked call against the JAX
    wrapper lane by lane, on the Pallas kernel in interpret mode where it
    takes the geometry and on the JAX package's plain reference where it
    does not (max_push + block > cap)."""
    cap, d, m, start, n, dtype = case
    rng = np.random.default_rng(9)
    jbuf, tbuf = _both(rng, (len(start), cap, d), dtype)
    jb, tb = _both(rng, (len(start), m, d), dtype)
    got = tbuf.clone()
    assert push_scatter(got, tb, _vec(*start), _vec(*n)) is got
    pallas = ring_scatter_supported(cap, m)
    for l in range(len(start)):
        want = jax_push_scatter(jbuf[l], jb[l], jnp.int32(start[l]),
                                jnp.int32(n[l]), interpret=pallas)
        assert_same(want, got[l], f"ring_scatter {case} lane {l}")


def _tree_leaves(count):
    """``cases.TREE_LEAVES`` (3 leaves: one launch of K1-K4 on the card) or
    four copies of it (12 leaves: two launches)."""
    return {f"{k}{i}": v for i in range(count // len(C.TREE_LEAVES))
            for k, v in C.TREE_LEAVES.items()}


@pytest.mark.parametrize("count", [3, 12])
def test_push_scatter_tree_matches_pallas(count):
    """K2 on the mixed-dtype payload tree at ``cases.SCATTER_TREE_CASE``
    (a lane that wraps the ring, one with n = 0, one with a negative start
    and n past max_push, a start past cap, a negative n): one call of the
    tree wrapper, in place, against the JAX wrapper on the Pallas kernel in
    interpret mode, lane by lane and leaf by leaf, bit for bit."""
    cap, m, start, n = C.SCATTER_TREE_CASE
    leaves = _tree_leaves(count)
    dtypes = {k: dt for k, (_, dt) in leaves.items()}
    rng = np.random.default_rng(10)

    def both(lead):
        arrays = C.tree_payload(rng, lead, leaves)
        return ({k: jax_payload(a, dtypes[k]) for k, a in arrays.items()},
                {k: C.to_tensor(a, dtypes[k], CPU) for k, a in arrays.items()})

    jr, tr = both((len(start), cap))
    jb, tb = both((len(start), m))
    got = {k: v.clone() for k, v in tr.items()}
    assert push_scatter(got, tb, _vec(*start), _vec(*n)) is got
    assert ring_scatter_supported(cap, m)
    for l in range(len(start)):
        want = jax_push_scatter({k: v[l] for k, v in jr.items()},
                                {k: v[l] for k, v in jb.items()},
                                jnp.int32(start[l]), jnp.int32(n[l]),
                                interpret=True)
        for k in dtypes:
            assert_same(want[k], got[k][l], f"push_scatter {k} lane {l}")


@pytest.mark.parametrize("fault", ["ring_rows", "batch_rows", "lanes",
                                   "dtype", "row_shape"])
def test_push_scatter_refuses_unlike_leaves_before_writing(fault):
    """K2's tree wrapper takes ring leaves ``(lanes, cap, ...)`` and batch
    leaves ``(lanes, max_push, ...)`` of the ring's dtype and row shape, all
    alike.  A tree whose second leaf breaks that raises ``ValueError``
    before the first leaf is written, on the CPU and on another device
    alike, where nothing launches."""
    rings = {"a": torch.zeros((2, 8, 3), dtype=I32),
             "b": torch.zeros((2, 8, 3), dtype=I32)}
    batches = {"a": torch.ones((2, 4, 3), dtype=I32),
               "b": torch.ones((2, 4, 3), dtype=I32)}
    if fault == "ring_rows":
        rings["b"] = torch.zeros((2, 9, 3), dtype=I32)
    elif fault == "batch_rows":
        batches["b"] = torch.ones((2, 5, 3), dtype=I32)
    elif fault == "lanes":
        rings["b"] = torch.zeros((3, 8, 3), dtype=I32)
        batches["b"] = torch.ones((3, 4, 3), dtype=I32)
    elif fault == "dtype":
        batches["b"] = torch.ones((2, 4, 3), dtype=torch.float32)
    else:
        batches["b"] = torch.ones((2, 4, 2), dtype=I32)
    match = ("must match" if fault in ("dtype", "row_shape")
             else "every ring leaf")
    with pytest.raises(ValueError, match=match):
        push_scatter(rings, batches, _vec(1, 6), _vec(4, 4))
    assert not rings["a"].any()
    before = push_scatter.launches
    meta = {k: v.to("meta") for k, v in rings.items()}
    with pytest.raises(ValueError, match=match):
        push_scatter(meta, {k: v.to("meta") for k, v in batches.items()},
                     _vec(1, 6).to("meta"), _vec(4, 4).to("meta"))
    assert push_scatter.launches == before


@pytest.mark.parametrize("kernel", ["gather", "transfer"])
def test_payload_tree_matches_pallas(kernel):
    """The mixed-dtype payload tree (int32 ``(L, cap)``, bfloat16 ``(L,
    cap, 3)``, float32 ``(L, cap, 5)``) through one call of the tree
    wrapper, against the JAX wrapper on the same tree, lane by lane."""
    cap, m, w, start, n, src = C.TREE_CASE
    dtypes = {k: dt for k, (_, dt) in C.TREE_LEAVES.items()}
    rng = np.random.default_rng(8)

    def both(lead):
        arrays = C.tree_payload(rng, lead)
        return ({k: jax_payload(a, dtypes[k]) for k, a in arrays.items()},
                {k: C.to_tensor(a, dtypes[k], CPU) for k, a in arrays.items()})

    jr, tr = both((len(start), cap))
    if kernel == "gather":
        got = steal_gather(tr, _vec(*start), _vec(*n), max_steal=m)
        want = [jax_steal_gather({k: v[l] for k, v in jr.items()},
                                 jnp.int32(start[l]), jnp.int32(n[l]),
                                 max_steal=m, interpret=True)
                for l in range(len(start))]
    else:
        js, ts = both((w, m))
        got = {k: v.clone() for k, v in tr.items()}
        assert transfer_splice(got, ts, _vec(*start), _vec(*src), _vec(*n),
                               max_steal=m) is got
        want = [jax_transfer_splice({k: v[l] for k, v in jr.items()}, js,
                                    jnp.int32(start[l]), jnp.int32(src[l]),
                                    jnp.int32(n[l]), max_steal=m,
                                    interpret=True)
                for l in range(len(start))]
    for l in range(len(start)):
        for k in dtypes:
            assert_same(want[l][k], got[k][l], f"{kernel} {k} lane {l}")


def test_ring_trees_split_and_refuse():
    """K1 / K4 take at most eight leaves a launch: a twelve-leaf tree makes
    two descriptors, leaves of empty rows none, and a row's bytes come from
    the ``(lanes, rows, ...)`` side; a ring whose bytes pass 32 bits is
    refused before anything launches."""
    # K4's pairs: a flat (W * max_steal, 3) stack into a (lanes, cap, 3) ring
    pair = (torch.zeros((8, 3)), torch.zeros((2, 4, 3)))
    empty = (torch.zeros((8, 0)), torch.zeros((2, 4, 0)))
    trees = list(_lib.ring_trees([pair] * 12 + [empty], 8))
    assert [t.count for t in trees] == [8, 4]
    assert {t.leaf[i].row_bytes for t in trees for i in range(t.count)} \
        == {12}
    with pytest.raises(ValueError, match="32-bit"):
        list(_lib.ring_trees([pair], 2 ** 31 // 12 + 1))


def test_wrappers_refuse_non_cpu_tensors_without_cuda(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: it
    goes to the CUDA kernel or raises; K6 and K7 on ``meta`` tensors (the
    dry run's trace) return empty outputs of their shapes."""
    buf = torch.empty((2, 16, 1), dtype=I32, device="meta")
    cursor = torch.zeros((2,), dtype=I32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ring_gather(buf, cursor, cursor, 8)
    with pytest.raises(ValueError, match="int32"):
        ring_gather(buf, cursor.long(), cursor, 8)
    # K2's tree wrapper: the whole tree goes to the kernel or raises
    before = push_scatter.launches
    with pytest.raises(ValueError, match="CUDA"):
        push_scatter({"a": buf, "b": buf.clone()}, {"a": buf, "b": buf},
                     cursor, cursor)
    assert push_scatter.launches == before
    # K5 and K7 likewise
    nodes = torch.zeros((4, 8), dtype=I32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        expand_pool(nodes, nodes, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        expand_layer_bulk(nodes[0], nodes[0], torch.zeros((), dtype=I32), 4)
    f32 = dict(dtype=torch.float32, device="meta")
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on meta tensors")

    monkeypatch.setattr(ssd_ops, "ssd_chunked", plain)
    before = ssd.launches
    y, final = ssd(torch.empty((1, 8, 2, 16), **f32),
                   torch.empty((1, 8, 2), **f32), torch.empty((2,), **f32),
                   torch.empty((1, 8, 16), **f32),
                   torch.empty((1, 8, 16), **f32), torch.empty((2,), **f32),
                   chunk=4)
    assert y.device.type == final.device.type == "meta"
    assert y.shape == (1, 8, 2, 16) and final.shape == (1, 2, 16, 16)
    assert ssd.launches == before


@pytest.mark.parametrize("extent", [-1, 2 ** 31])
def test_launch_refuses_extents_past_32_bits(extent):
    """An extent the kernels' 32-bit ``int`` arguments cannot hold raises
    before the library is built or loaded, never wraps around."""
    with pytest.raises(ValueError, match="32-bit"):
        _lib.launch("rk_ring_gather", _lib.RingTree(), 0, 0, 1, extent, 8,
                    device=torch.device("cuda"))
