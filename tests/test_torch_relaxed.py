"""The port's ``"relaxed"`` backend (``repro_torch.core.relaxed``) against
the JAX package's (``repro.core.relaxed``) on numpy-seeded inputs: the
registry and its predicate, the unmasked over-report of the optimistic
window, ``reconcile`` over seeded sizes, claims and floors, the relaxed
steals against both the JAX backend and the port's fenced routing, donate
against pure, the superstep on ``relaxed`` bit-equal to ``reference`` for
both exchanges, and the one-shot fallback warning."""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core import relaxed as jrelaxed
from repro.core.policy import StealPolicy as JaxPolicy
from repro.core.sharded_queue import vmapped_superstep
from repro_torch.core import ops as tops
from repro_torch.core import relaxed as trelaxed
from repro_torch.core.master import superstep
from repro_torch.core.policy import StealPolicy

from _torch_parity import assert_same, one_torch_thread  # noqa: F401

CPU = "cpu"
CAP, MS = 16, 8


def _np_state(rng, cap=CAP, lanes=None):
    shape = (lanes,) if lanes else ()
    buf = rng.integers(1, 10 ** 6, shape + (cap,)).astype(np.int32)
    lo = rng.integers(0, cap, shape).astype(np.int32)
    size = rng.integers(0, cap + 1, shape).astype(np.int32)
    return buf, lo, size


def _jax_q(buf, lo, size):
    return jops.QueueState(buf=jnp.asarray(buf), lo=jnp.int32(lo),
                           size=jnp.int32(size))


def _port_q(buf, lo, size):
    return tops.QueueState(buf=torch.from_numpy(np.array(buf)),
                           lo=torch.from_numpy(np.asarray(lo, np.int32)),
                           size=torch.from_numpy(np.asarray(size, np.int32)))


def _same_state(jq, tq, what):
    assert_same(np.asarray(jq.buf), tq.buf, f"{what}: ring")
    assert_same(np.asarray(jq.lo, np.int32), tq.lo, f"{what}: lo")
    assert_same(np.asarray(jq.size, np.int32), tq.size, f"{what}: size")


def test_registry_and_predicate():
    assert "relaxed" in tops.available_backends()
    for cap in (None, 0, 1, 8, 64):
        for ms in (None, 0, 1, 8, 64, 128):
            assert (trelaxed.relaxed_supported(cap, ms)
                    == jrelaxed.relaxed_supported(cap, ms)), (cap, ms)
    ok = tops.make_ops("relaxed", capacity=64, max_steal=32, check=False)
    assert isinstance(ok, trelaxed.RelaxedBulkOps)
    assert ok.name == ok.resolved == "relaxed"
    jok = jops.make_ops("relaxed", capacity=64, max_steal=32, check=False)
    assert ok.multiplicity_bound(32) == jok.multiplicity_bound(32) == 32
    # equality by type: every RelaxedBulkOps is one routing, and it is not
    # the fenced kernel routing
    assert ok == tops.make_ops("relaxed", capacity=8, max_steal=4)
    assert ok != tops.make_ops("cuda") and tops.make_ops("cuda") != ok
    assert len({ok, trelaxed.RelaxedBulkOps()}) == 1
    tops.reset_fallback_warnings()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tops.BackendFallbackWarning)
        # the fallback: same name, the fenced routing ("auto"'s kernel
        # routing here, the reference routing in the JAX package)
        fb = tops.make_ops("relaxed", capacity=64, max_steal=128)
        assert not isinstance(fb, trelaxed.RelaxedBulkOps)
        assert fb.name == "relaxed" and fb.resolved == "cuda"
        assert tops.make_ops("relaxed").resolved == "cuda"
    tops.reset_fallback_warnings()


def test_geometry_keywords_leave_the_fenced_routings_alone():
    for name in ("reference", "cuda", "auto"):
        assert (tops.make_ops(name, capacity=8, max_steal=4)
                == tops.make_ops(name))


@pytest.mark.parametrize("seed", range(4))
def test_optimistic_window_is_unmasked_overreport(seed):
    """The fence-free read claims the whole window: rows past ``size``
    carry ring bytes, as in the JAX package, on one queue and on lanes."""
    rng = np.random.default_rng(seed)
    buf, lo, size = _np_state(rng)
    size = np.int32(min(size, MS - 3))
    got = trelaxed.optimistic_read(_port_q(buf, lo, size), MS)
    want = jrelaxed.optimistic_read(_jax_q(buf, lo, size), MS)
    assert_same(np.asarray(want), got, "window")
    assert int((got != 0).sum()) > int(size)  # stale rows were read
    bufs, los, sizes = _np_state(rng, lanes=5)
    lanes = trelaxed.optimistic_read(_port_q(bufs, los, sizes), MS)
    for l in range(5):
        assert_same(np.asarray(jrelaxed.optimistic_read(
            _jax_q(bufs[l], los[l], sizes[l]), MS)), lanes[l], f"lane {l}")


@pytest.mark.parametrize("seed", range(4))
def test_reconcile_matches_jax_over_seeded_claims_and_floors(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        buf, lo, size = _np_state(rng)
        w_buf, w_lo, _ = _np_state(rng)  # the window of an earlier state
        window = jrelaxed.optimistic_read(_jax_q(w_buf, w_lo, size), MS)
        claim = int(rng.integers(-3, MS + 6))
        floor = (None if rng.random() < 0.3
                 else int(rng.integers(-2, CAP + 1)))
        jq, jb, jn = jrelaxed.reconcile(
            _jax_q(buf, lo, size), window, jnp.int32(claim), MS,
            floor=None if floor is None else jnp.int32(floor))
        tq, tb, tn = trelaxed.reconcile(
            _port_q(buf, lo, size), torch.from_numpy(np.array(window)),
            torch.tensor(claim, dtype=torch.int32), MS,
            floor=None if floor is None else torch.tensor(floor,
                                                          dtype=torch.int32))
        what = f"claim {claim} floor {floor} size {size}"
        _same_state(jq, tq, what)
        assert_same(np.asarray(jb), tb, what)
        assert int(jn) == int(tn), what
        n_exp = min(min(max(claim, 0), MS), int(size))
        if floor is not None:
            n_exp = min(n_exp, max(floor, 0))
        assert int(tn) == n_exp, what


@pytest.mark.parametrize("seed", range(3))
def test_relaxed_steals_match_jax_and_the_fenced_routing(seed):
    rng = np.random.default_rng(200 + seed)
    rel = tops.make_ops("relaxed", capacity=CAP, max_steal=MS)
    jrel = jops.make_ops("relaxed", capacity=CAP, max_steal=MS)
    fenced = tops.make_ops("reference")
    for _ in range(25):
        buf, lo, size = _np_state(rng)
        p = float(rng.choice([0.1, 0.3, 0.5, 0.6, 0.9, 1.0, 1.5]))
        n = int(rng.integers(-2, MS + 4))
        ql = int(rng.integers(0, 4))
        runs = (
            (lambda o, q: o.steal(q, p, max_steal=MS, queue_limit=ql),
             f"steal p={p} ql={ql}"),
            (lambda o, q: o.steal_exact(q, n, max_steal=MS),
             f"steal_exact n={n}"))
        for run, what in runs:
            jq, jb, jn = run(jrel, _jax_q(buf, lo, size))
            tq, tb, tn = run(rel, _port_q(buf, lo, size))
            fq, fb, fn = run(fenced, _port_q(buf, lo, size))
            _same_state(jq, tq, what)
            assert_same(np.asarray(jb), tb, what)
            assert int(jn) == int(tn) == int(fn), what
            assert torch.equal(tb, fb) and torch.equal(tq.lo, fq.lo)
    # stacked lanes, per-lane counts: lane by lane equal to the JAX backend
    bufs, los, sizes = _np_state(rng, lanes=6)
    ns = rng.integers(0, MS + 2, 6).astype(np.int32)
    tq, tb, tn = rel.steal_exact(_port_q(bufs, los, sizes),
                                 torch.from_numpy(ns), max_steal=MS)
    for l in range(6):
        jq, jb, jn = jrel.steal_exact(_jax_q(bufs[l], los[l], sizes[l]),
                                      jnp.int32(ns[l]), max_steal=MS)
        assert_same(np.asarray(jb), tb[l], f"lane {l}")
        assert int(jn) == int(tn[l]) and int(jq.lo) == int(tq.lo[l])


def test_relaxed_donate_matches_pure():
    rng = np.random.default_rng(7)
    rel = tops.make_ops("relaxed", capacity=CAP, max_steal=MS)
    buf, lo, size = _np_state(rng)
    pure_q, pure_b, pure_n = rel.steal_exact(_port_q(buf, lo, size), 5,
                                             max_steal=MS)
    don_q, don_b, don_n = rel.steal_exact(_port_q(buf, lo, size), 5,
                                          max_steal=MS, donate=True)
    assert int(pure_n) == int(don_n)
    assert torch.equal(pure_b, don_b) and torch.equal(pure_q.buf, don_q.buf)
    assert torch.equal(pure_q.lo, don_q.lo)
    assert torch.equal(pure_q.size, don_q.size)


def _seeded_lanes(sizes, cap):
    buf = np.zeros((len(sizes), cap), np.int32)
    nxt = 1
    for i, n in enumerate(sizes):
        buf[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    return buf, np.zeros(len(sizes), np.int32), np.asarray(sizes, np.int32)


@pytest.mark.parametrize("exchange", ["compact", "dense"])
def test_relaxed_superstep_equals_reference_and_jax(exchange):
    """Three supersteps of the virtual master: ``relaxed`` bit-equal to
    ``reference`` in the port and to ``relaxed`` in the JAX package."""
    cap, sizes = 128, [40, 0, 0, 0, 25, 0, 3, 0]
    buf, lo, size = _seeded_lanes(sizes, cap)
    kw = dict(proportion=0.5, low_watermark=2, high_watermark=8,
              max_steal=32, exchange=exchange)
    out = {}
    for backend in ("reference", "relaxed"):
        ops = tops.make_ops(backend, capacity=cap, max_steal=32)
        q = _port_q(buf, lo, size)
        for _ in range(3):
            q, _ = superstep(q, StealPolicy(**kw), ops=ops, donate=True)
        out[backend] = q
    assert isinstance(tops.make_ops("relaxed", capacity=cap, max_steal=32),
                      trelaxed.RelaxedBulkOps)
    assert torch.equal(out["reference"].buf, out["relaxed"].buf)
    assert torch.equal(out["reference"].lo, out["relaxed"].lo)
    assert torch.equal(out["reference"].size, out["relaxed"].size)
    step = vmapped_superstep(
        JaxPolicy(**kw), ops=jops.make_ops("relaxed", capacity=cap,
                                           max_push=32, max_steal=32))
    jq = jops.QueueState(buf=jnp.asarray(buf), lo=jnp.asarray(lo),
                         size=jnp.asarray(size))
    for _ in range(3):
        jq, _ = step(jq)
    _same_state(jq, out["relaxed"], exchange)


def test_relaxed_gate_moves_nothing_when_off():
    rng = np.random.default_rng(3)
    rel = tops.make_ops("relaxed", capacity=CAP, max_steal=MS)
    bufs, los, sizes = _np_state(rng, lanes=4)
    q = _port_q(bufs, los, sizes)
    with rel.gated(torch.zeros((), dtype=torch.bool)):
        q2, b, n = rel.steal(q, 0.5, max_steal=MS, queue_limit=0)
    assert not n.any() and not b.any()
    assert torch.equal(q2.lo, q.lo) and torch.equal(q2.size, q.size)


def test_relaxed_fallback_warns_once():
    tops.reset_fallback_warnings()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert tops.make_ops("relaxed", capacity=64,
                             max_steal=128).resolved == "cuda"
        assert tops.make_ops("relaxed", capacity=64,
                             max_steal=128).resolved == "cuda"
    msgs = [str(r.message) for r in rec
            if issubclass(r.category, tops.BackendFallbackWarning)]
    assert len(msgs) == 1, msgs
    assert "relaxed" in msgs[0] and "fenced" in msgs[0]
    tops.reset_fallback_warnings()


def test_runtime_passes_its_geometry_to_the_backend():
    from repro_torch.runtime.executor import StealRuntime

    spec = torch.zeros((), dtype=torch.int32)
    rt = StealRuntime(4, 64, spec, policy=StealPolicy(max_steal=16),
                      backend="relaxed", device=CPU)
    assert isinstance(rt.ops, trelaxed.RelaxedBulkOps)
    assert rt.policy.backend == "relaxed"
    pol = dataclasses.replace(StealPolicy(), max_steal=128)
    tops.reset_fallback_warnings()
    with pytest.warns(tops.BackendFallbackWarning):
        rt = StealRuntime(4, 64, spec, policy=pol, backend="relaxed",
                          device=CPU)
    assert rt.ops.resolved == "cuda"
    tops.reset_fallback_warnings()
