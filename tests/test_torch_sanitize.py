"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``):
wrapping by ``check=True`` and by ``REPRO_CHECK``, idempotence, clean ops
(one queue and stacked lanes, every backend, donate or not) recording
nothing, a misreported count and a missing cursor write caught, a
violation inside ``run_fused`` raised at the block's read-back, the
gate applied to the expected counts, the float32 steal-plan mirror and
the multiset fingerprints against the JAX package's, and ``PagedQueue``'s
spill/refill accounting, clean and broken."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as jsanitize
from repro.core import ops as jops
from repro_torch.analysis import sanitize
from repro_torch.analysis.sanitize import CheckedBulkOps, SanitizerError
from repro_torch.core import ops as tops
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime.executor import StealRuntime

from _torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
SPEC = torch.zeros((), dtype=torch.int32)


@pytest.fixture(autouse=True)
def _clean_slate():
    sanitize.reset_violations()
    yield
    sanitize.reset_violations()


def _seeded(values, cap=16, *, backend="reference", check=True):
    ops = tops.make_ops(backend, capacity=cap, max_steal=cap // 2,
                        check=check)
    q = tops.make_queue(cap, SPEC, device=CPU)
    buf = torch.zeros((max(len(values), 1),), dtype=torch.int32)
    buf[:len(values)] = torch.tensor(values, dtype=torch.int32)
    q, _ = ops.push(q, buf, len(values))
    return ops, q


def _lanes(rng, lanes=5, cap=16):
    return tops.QueueState(
        buf={"id": torch.from_numpy(rng.integers(1, 10 ** 6, (lanes, cap))
                                    .astype(np.int32)),
             "v": torch.from_numpy(rng.standard_normal((lanes, cap, 2))
                                   .astype(np.float32))},
        lo=torch.from_numpy(rng.integers(0, cap, lanes).astype(np.int32)),
        size=torch.from_numpy(rng.integers(0, cap + 1, lanes)
                              .astype(np.int32)))


# -- wiring -----------------------------------------------------------------


def test_check_true_wraps_and_env_wraps(monkeypatch):
    monkeypatch.delenv(tops.CHECK_ENV_VAR, raising=False)
    assert tops.CHECK_ENV_VAR == jops.CHECK_ENV_VAR == "REPRO_CHECK"
    assert isinstance(tops.make_ops("reference", check=True), CheckedBulkOps)
    assert not isinstance(tops.make_ops("reference", check=False),
                          CheckedBulkOps)
    assert not isinstance(tops.make_ops("cuda"), CheckedBulkOps)
    for on in ("1", "true", "on"):
        monkeypatch.setenv(tops.CHECK_ENV_VAR, on)
        assert sanitize.checking_enabled()
        assert isinstance(tops.make_ops("cuda"), CheckedBulkOps)
        assert not isinstance(tops.make_ops("cuda", check=False),
                              CheckedBulkOps)
    monkeypatch.setenv(tops.CHECK_ENV_VAR, "0")
    assert not isinstance(tops.make_ops("reference"), CheckedBulkOps)


def test_wrapping_is_idempotent_and_delegates():
    inner = tops.make_ops("relaxed", capacity=64, max_steal=16, check=False)
    once = tops.make_ops(inner, check=True)
    twice = tops.make_ops(once, check=True)
    assert isinstance(once, CheckedBulkOps) and twice is once
    assert twice.inner is inner  # no double wrap
    assert once.resolved == inner.resolved == "relaxed"
    assert once.multiplicity_bound(16) == inner.multiplicity_bound(16)
    assert tops.make_ops("cuda", check=True) == tops.make_ops("cuda")


@pytest.mark.parametrize("backend", ["reference", "cuda", "relaxed"])
@pytest.mark.parametrize("donate", [False, True])
def test_clean_ops_record_nothing(backend, donate):
    ops, q = _seeded([1, 2, 3, 4, 5], backend=backend)
    q, batch, n = ops.pop_bulk(q, 4, torch.tensor(2), donate=donate)
    q, batch, n = ops.steal(q, 0.5, max_steal=8, queue_limit=0,
                            donate=donate)
    q, n = ops.push(q, torch.arange(10, 14, dtype=torch.int32), 4,
                    donate=donate)
    q, item, valid = ops.pop(q, donate=donate)
    window = ops.window(q, max_steal=8)
    q, n = ops.transfer(q, torch.stack([window, window]), 1, 3,
                        max_steal=8, donate=donate)
    q, batch, n = ops.steal_exact(q, 9, max_steal=8, donate=donate)
    # stacked lanes with per-lane counts and a two-leaf payload
    rng = np.random.default_rng(0)
    qs = _lanes(rng)
    qs, n = ops.push(qs, {"id": torch.ones((5, 6), dtype=torch.int32),
                          "v": torch.ones((5, 6, 2))},
                     torch.tensor([0, 6, 3, 5, 1], dtype=torch.int32),
                     donate=donate)
    qs, batch, n = ops.steal(qs, torch.tensor(0.3), max_steal=8,
                             donate=donate)
    qs, batch, n = ops.pop_bulk(qs, 4, torch.tensor([4, 0, 2, 9, 1]),
                                donate=donate)
    qs, item, valid = ops.pop(qs, donate=donate)
    assert sanitize.violations() == ()
    sanitize.assert_clean()


# -- corrupted backends are caught ------------------------------------------


class _LyingOps(tops.BulkOps):
    """Reference backend that misreports the push count."""

    def __init__(self):
        super().__init__("reference", kernel=False)

    def push(self, q, batch, n, *, donate=False):
        q2, n_pushed = super().push(q, batch, n, donate=donate)
        return q2, n_pushed + 1


class _LeakyOps(tops.BulkOps):
    """Reference backend whose steal forgets the ``lo += n`` write (items
    duplicated: still in the ring AND in the stolen batch)."""

    def __init__(self):
        super().__init__("reference", kernel=False)

    def steal_exact(self, q, n, *, max_steal, donate=False):
        _, batch, n_out = super().steal_exact(q, n, max_steal=max_steal)
        return q, batch, n_out


def test_misreported_count_is_caught():
    checked = CheckedBulkOps(_LyingOps())
    q = tops.make_queue(8, SPEC, device=CPU)
    with pytest.raises(SanitizerError, match="push"):
        checked.push(q, torch.arange(3, dtype=torch.int32), 3)


def test_missing_cursor_write_is_caught_on_one_lane():
    checked = CheckedBulkOps(_LeakyOps())
    _, q = _seeded([1, 2, 3, 4])
    with pytest.raises(SanitizerError, match="steal_exact"):
        checked.steal_exact(q, 2, max_steal=4)
    sanitize.reset_violations()
    rng = np.random.default_rng(1)
    qs = _lanes(rng)
    n = torch.tensor([0, 0, 1, 0, 0], dtype=torch.int32)
    qs = qs._replace(size=torch.full((5,), 4, dtype=torch.int32))
    with sanitize.deferred():
        checked.steal_exact(qs, n, max_steal=4)
    msgs = sanitize.violations()
    assert msgs and all("lane 2" in m for m in msgs), msgs


def test_violation_in_run_fused_raises_at_the_read_back():
    class _LyingTransfer(tops.BulkOps):
        def __init__(self):
            super().__init__("reference", kernel=False)

        def transfer(self, q, gathered, src_row, n, *, max_steal,
                     donate=False):
            q2, n_out = super().transfer(q, gathered, src_row, n,
                                         max_steal=max_steal, donate=donate)
            return q2._replace(size=q2.size + (n_out > 0).to(torch.int32)), \
                n_out

    rt = StealRuntime(4, 32, SPEC, policy=StealPolicy(max_steal=8),
                      backend=CheckedBulkOps(_LyingTransfer()), device=CPU)
    assert rt._check
    rt.push(0, torch.arange(1, 21, dtype=torch.int32), 20)
    with pytest.raises(SanitizerError,
                       match=r"at StealRuntime\.run_fused\[3 rounds\]"):
        rt.run_fused(3)
    assert sanitize.violations() == ()  # drained by the raise


@pytest.mark.parametrize("backend", ["reference", "cuda", "relaxed"])
def test_checked_runtime_is_clean_and_equal_to_unchecked(backend):
    """Rounds with and without a worker body, a gated drained block, both
    exchanges: the checked runtime records nothing and ends bit-equal to
    the unchecked one."""
    def run(check):
        out = []
        for exchange in ("compact", "dense"):
            rt = StealRuntime(6, 64, {"a": SPEC, "b": SPEC},
                              policy=StealPolicy(max_steal=16,
                                                 exchange=exchange),
                              backend=tops.make_ops(
                                  backend, capacity=64, max_steal=16,
                                  check=check) if check else backend,
                              device=CPU)
            assert rt._check == check
            ids = torch.arange(1, 41, dtype=torch.int32)
            rt.push(0, {"a": ids, "b": -ids}, 40)
            rt.push(3, {"a": ids + 100, "b": ids}, 25)
            rt.round()
            rt.run_fused(3)

            def body(qs, carry):  # pop up to 2 items a lane
                qs, _, n = rt.ops.pop_bulk(qs, 2, 2, donate=True)
                return qs, carry + n

            rt.run(body, fused=4)
            out.append(tops.queue_to_numpy(rt.queues))
        return out

    for a, b in zip(run(False), run(True)):
        for k in ("a", "b"):
            np.testing.assert_array_equal(a.buf[k], b.buf[k])
        np.testing.assert_array_equal(a.size, b.size)
    assert sanitize.violations() == ()


def test_gated_ops_expect_no_move():
    ops = tops.make_ops("cuda", check=True)
    rng = np.random.default_rng(2)
    qs = _lanes(rng)
    with ops.gated(torch.zeros((), dtype=torch.bool)):
        assert ops.inner._gate is not None  # the gate reaches the backend
        qs2, n = ops.push(qs, {"id": torch.ones((5, 4), dtype=torch.int32),
                               "v": torch.ones((5, 4, 2))}, 4)
        qs2, _, n = ops.steal(qs2, 0.5, max_steal=8)
        qs2, _, valid = ops.pop(qs2)
    assert ops.inner._gate is None
    assert torch.equal(qs2.size, qs.size) and not valid.any()
    sanitize.assert_clean()


# -- violation lifecycle ----------------------------------------------------


def test_record_then_raise_pending_drains():
    sanitize.record_violation("synthetic A")
    sanitize.record_violation("synthetic B")
    assert len(sanitize.violations()) == 2
    with pytest.raises(SanitizerError, match="synthetic A"):
        sanitize.raise_pending("test context")
    assert sanitize.violations() == ()
    sanitize.assert_clean()


def test_eager_violation_raises_unless_deferred():
    with pytest.raises(SanitizerError, match="boom"):
        sanitize.record_violation("boom", eager=True)
    sanitize.reset_violations()
    with sanitize.deferred():
        sanitize.record_violation("later", eager=True)
    with pytest.raises(SanitizerError, match="later"):
        sanitize.assert_clean()


def test_superstep_conservation_check():
    sizes = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    sanitize.trace_check_superstep(sizes, torch.tensor([7, 0, 2, 9]),
                                   capacity=16)
    assert sanitize.violations() == ()
    sanitize.trace_check_superstep(sizes, torch.tensor([7, 1, 2, 9]),
                                   capacity=16)
    assert any("conserv" in v for v in sanitize.violations())


class _Dropping(tops.BulkOps):
    """The splice forgets one item."""

    def __init__(self):
        super().__init__("reference", kernel=False)

    def transfer(self, q, gathered, src_row, n, *, max_steal, donate=False):
        q2, n_out = super().transfer(q, gathered, src_row, n,
                                     max_steal=max_steal, donate=donate)
        return q2._replace(size=q2.size - (n_out > 0).to(torch.int32)), n_out


def _one_full_lane():
    return tops.QueueState(torch.arange(64, dtype=torch.int32).reshape(4, 16),
                           torch.zeros(4, dtype=torch.int32),
                           torch.tensor([12, 0, 0, 0], dtype=torch.int32))


def test_superstep_under_repro_check_records_a_lost_item(monkeypatch):
    from repro_torch.core.master import superstep

    monkeypatch.setenv(tops.CHECK_ENV_VAR, "1")
    ops = tops.make_ops(_Dropping())  # wrapped by the environment switch
    assert ops.checked
    with sanitize.deferred():  # as in a round: recorded, not raised
        superstep(_one_full_lane(), StealPolicy(max_steal=8), ops=ops)
    assert any("sum(sizes) not conserved" in v
               for v in sanitize.violations())


def test_repro_check_leaves_explicitly_unchecked_ops_alone(monkeypatch):
    """``check=False`` wins over ``REPRO_CHECK=1``: the superstep records
    nothing for ops that were not wrapped, so no stale violation reaches
    the next checked runtime's checkpoint."""
    from repro_torch.core.master import superstep

    monkeypatch.setenv(tops.CHECK_ENV_VAR, "1")
    ops = tops.make_ops(_Dropping(), check=False)
    assert not ops.checked
    q, _ = superstep(_one_full_lane(), StealPolicy(max_steal=8), ops=ops)
    assert int(q.size.sum()) < 12  # the splice did drop items, unchecked
    assert sanitize.violations() == ()
    rt = StealRuntime(4, 16, SPEC, policy=StealPolicy(max_steal=8),
                      backend="reference", device=CPU)
    assert rt._check
    rt.push(0, torch.arange(1, 13, dtype=torch.int32), 12)
    rt.round()
    rt.run_fused(2)
    assert rt.total_size() == 12
    sanitize.assert_clean()


def test_round_stats_check():
    from repro_torch.core.master import RebalanceStats

    ok = RebalanceStats(np.array([3, 4]), np.array([5, 2]), np.int32(2),
                        np.int32(1), np.int32(8))
    sanitize.check_round_stats(ok, n_workers=2, capacity=8)
    assert sanitize.violations() == ()
    bad = ok._replace(sizes_after=np.array([5, 3]), n_steals=np.int32(-1))
    sanitize.check_round_stats(bad, n_workers=2, capacity=8)
    assert len(sanitize.violations()) == 2


@pytest.mark.parametrize("seed", range(3))
def test_float32_steal_plan_mirror_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        size = int(rng.integers(0, 5000))
        p = float(rng.choice([0.1, 0.3, 0.7, 0.9, 1.0 / 3, rng.random()]))
        ql, ms = int(rng.integers(0, 4)), int(rng.integers(1, 4096))
        want = jsanitize._mirror_steal_plan(size, p, ql, ms)
        assert sanitize._mirror_steal_plan(size, p, ql, ms) == want
        p32 = np.float32(p)
        assert (sanitize._mirror_steal_plan(size, torch.tensor(p32), ql, ms)
                == jsanitize._mirror_steal_plan(size, jnp.float32(p32), ql,
                                                ms))
    # ROADMAP C4's case: 10 items at p = 0.9 steal 9 in float32 (10 in
    # float64)
    assert sanitize._mirror_steal_plan(10, 0.9, 0, 16) == 9


# -- multiset fingerprints --------------------------------------------------


def _stack(*value_lists, cap=16):
    buf = torch.zeros((len(value_lists), cap), dtype=torch.int32)
    lo = torch.tensor([(3 * i) % cap for i in range(len(value_lists))],
                      dtype=torch.int32)
    for i, vals in enumerate(value_lists):
        for j, v in enumerate(vals):
            buf[i, (int(lo[i]) + j) % cap] = v
    size = torch.tensor([len(v) for v in value_lists], dtype=torch.int32)
    return tops.QueueState(buf, lo, size)


def test_fingerprint_is_order_independent_and_matches_jax():
    qa = _stack([1, 2, 3], [4, 5])
    fa = sanitize.queues_fingerprint(qa)
    fb = sanitize.queues_fingerprint(_stack([5, 4], [3, 1, 2]))
    sanitize.check_conserved(fa, fb, context="permuted")
    assert sanitize.violations() == ()
    jq = jops.QueueState(jnp.asarray(qa.buf.numpy()), jnp.asarray(qa.lo),
                         jnp.asarray(qa.size))
    for a, b in zip(jsanitize.queues_fingerprint(jq), fa):
        np.testing.assert_array_equal(a, b)


def test_fingerprint_detects_lost_and_replaced_items():
    fa = sanitize.queues_fingerprint(_stack([1, 2, 3], [4]))
    sanitize.check_conserved(fa, sanitize.queues_fingerprint(
        _stack([1, 2], [4])), context="lost")
    sanitize.check_conserved(fa, sanitize.queues_fingerprint(
        _stack([1, 2, 2], [4])), context="replaced")
    msgs = sanitize.violations()
    assert any("lost" in m for m in msgs)
    assert any("duplicated or replaced" in m for m in msgs)


# -- PagedQueue spill/refill accounting -------------------------------------


def test_paged_queue_accounting_clean(monkeypatch):
    monkeypatch.setenv(tops.CHECK_ENV_VAR, "1")
    from repro_torch.core.queue import PagedQueue

    pq = PagedQueue(16, SPEC, backend="reference", device=CPU)
    assert pq._check
    for start in (0, 20, 40):  # overflow -> host pages
        pq.push(torch.arange(start, start + 12, dtype=torch.int32), 12)
    got = pq.steal(0.5)
    assert sum(n for _, n in got) > 0
    while pq.pop()[1]:
        pass
    assert pq.total_size() == 0
    sanitize.assert_clean()


def test_paged_queue_broken_accounting_is_caught(monkeypatch):
    monkeypatch.setenv(tops.CHECK_ENV_VAR, "1")
    from repro_torch.core.queue import PagedQueue

    pq = PagedQueue(16, SPEC, backend="cuda", device=CPU)
    pq.push(torch.arange(8, dtype=torch.int32), 8)
    pq.pages.append((torch.arange(4, dtype=torch.int32), 4))  # smuggled
    with pytest.raises(SanitizerError, match="accounting"):
        pq.pop()
    pq = PagedQueue(16, SPEC, backend="cuda", device=CPU)
    pq.pages.append((torch.arange(4, dtype=torch.int32), 5))  # over-count
    pq._net_in += 5
    with pytest.raises(SanitizerError, match="host page count"):
        pq.steal(0.0)  # takes nothing, audits the pages
