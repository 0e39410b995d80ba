"""The port's runtime (``repro_torch.runtime``) against the JAX package's:
``adaptive_update`` bit for bit, and ``StealRuntime`` — host-driven
``round``s, ``run_fused`` blocks and ``run`` — from skewed seeded sizes,
with and without a worker body.  Rounds, the ``RoundRecord`` stream, the
proportion history, carries and the final rings must be equal, including
a block that drains mid-way (the rounds past the drain must change
nothing)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import StealPolicy as JaxPolicy
from repro.runtime import StealRuntime as JaxRuntime
from repro.runtime.adaptive import AdaptiveConfig as JaxConfig
from repro.runtime.adaptive import adaptive_update as jax_adaptive_update
from repro_torch.core.ops import to_numpy
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime.adaptive import AdaptiveConfig, adaptive_update
from repro_torch.runtime.executor import StealRuntime
from repro_torch.runtime.telemetry import RoundRecord

from _torch_parity import assert_same, one_torch_thread  # noqa: F401

JSPEC = jax.ShapeDtypeStruct((), jnp.int32)
TSPEC = torch.zeros((), dtype=torch.int32)
CAP = 128
FIELDS = [f.name for f in dataclasses.fields(RoundRecord)]


def test_adaptive_update_is_bit_equal():
    rng = np.random.default_rng(0)
    for _ in range(200):
        w = int(rng.choice([4, 8]))
        sizes = rng.integers(0, 20, w).astype(np.int32)
        p = np.float32(rng.uniform(0.05, 0.95))
        kw = dict(proportion=float(rng.choice([0.25, 0.3, 0.5, 0.7])),
                  low_watermark=int(rng.integers(0, 4)),
                  high_watermark=int(rng.integers(2, 12)))
        ckw = dict(min_proportion=float(rng.choice([0.1, 0.125])),
                   max_proportion=float(rng.choice([0.6, 0.75])),
                   gain=float(rng.choice([0.3, 0.5, 1.0])))
        want = jax_adaptive_update(jnp.float32(p), jnp.asarray(sizes),
                                   policy=JaxPolicy(**kw),
                                   config=JaxConfig(**ckw))
        got = adaptive_update(torch.tensor(p), torch.as_tensor(sizes),
                              policy=StealPolicy(**kw),
                              config=AdaptiveConfig(**ckw))
        assert got.dtype == torch.float32
        assert_same(np.float32(want), got, f"{sizes} {p} {kw} {ckw}")


def _pair(sizes, policy_kw, backend=None, **kw):
    """A JAX runtime (geometry-resolved routing) and a port runtime
    (``backend``) seeded with the same unique ids."""
    jrt = JaxRuntime(len(sizes), CAP, JSPEC, policy=JaxPolicy(**policy_kw),
                     **kw)
    trt = StealRuntime(len(sizes), CAP, TSPEC,
                       policy=StealPolicy(**policy_kw), backend=backend,
                       device="cpu", **kw)
    nxt = 1
    for i, n in enumerate(sizes):
        if n:
            ids = np.arange(nxt, nxt + n, dtype=np.int32)
            assert jrt.push(i, jnp.asarray(ids), n) == n
            assert trt.push(i, torch.as_tensor(ids), n) == n
            nxt += n
    return jrt, trt


def _assert_runtimes_equal(jrt, trt):
    assert trt.rounds_run == jrt.rounds_run
    assert len(trt.telemetry.rounds) == len(jrt.telemetry.rounds)
    for a, b in zip(jrt.telemetry.rounds, trt.telemetry.rounds):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.round, f)
    if jrt.controller is not None:
        assert trt.controller.history == jrt.controller.history
    assert trt.telemetry.summary() == jrt.telemetry.summary()
    assert_same(np.asarray(jrt.queues.buf), trt.queues.buf, "rings")
    assert_same(np.asarray(jrt.queues.lo), trt.queues.lo, "lo")
    assert_same(np.asarray(jrt.queues.size), trt.queues.size, "size")


SKEWED = [60, 0, 0, 5, 0, 33, 0, 1]
POLICY = dict(proportion=0.5, low_watermark=1, high_watermark=4,
              max_steal=16)


@pytest.mark.parametrize("exchange", ["compact", "dense"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rounds_match_reference(exchange, backend):
    """Pure-rebalance host-driven rounds: records, proportion history and
    rings."""
    jrt, trt = _pair(SKEWED, dict(POLICY, exchange=exchange),
                     backend=backend)
    assert trt.ops.resolved == backend
    for _ in range(6):
        _, jstats = jrt.round()
        _, tstats = trt.round()
        assert int(tstats.n_transferred) == int(jstats.n_transferred[0])
    _assert_runtimes_equal(jrt, trt)


@pytest.mark.parametrize("until_drained", [False, True])
def test_run_fused_pure_rebalance_matches_reference(until_drained):
    """A fused block of pure rebalancing (nothing drains: every round
    runs) and its stacked stats."""
    jrt, trt = _pair(SKEWED, POLICY)
    jout = jrt.run_fused(7, until_drained=until_drained)
    tout = trt.run_fused(7, until_drained=until_drained)
    if until_drained:
        assert jout[2] == tout[2] == 7
    _assert_runtimes_equal(jrt, trt)
    for f in ("sizes_after", "n_transferred", "bytes_moved"):
        lanes = np.asarray(getattr(jout[1], f))  # (rounds, W, ...)
        assert_same(lanes[:, 0], getattr(tout[1], f), f)


def _bodies(jrt, trt):
    """A worker body that pushes one marker item, then pops up to two, on
    each lane: it drains the queues, and a round run after the drain
    would write the marker into a dead row and count a pop."""
    jops, tops = jrt.ops, trt.ops

    def jbody(q, carry):
        q, _ = jops.push(q, jnp.full((1,), -7, jnp.int32), jnp.int32(1))
        q, _, n = jops.pop_bulk(q, 2, jnp.int32(2))
        return q, carry + n

    def tbody(q, carry):
        w = q.size.shape[0]
        q, _ = tops.push(q, torch.full((w, 1), -7, dtype=torch.int32), 1,
                         donate=True)
        q, _, n = tops.pop_bulk(q, 2, 2, donate=True)
        return q, carry + n

    return jbody, tbody


def test_until_drained_stops_at_the_drain_like_the_reference():
    sizes = [9, 0, 4, 0]
    jrt, trt = _pair(sizes, POLICY)
    jbody, tbody = _bodies(jrt, trt)
    jcarry, jstats, jr = jrt.run_fused(12, jbody, jnp.zeros(4, jnp.int32),
                                       until_drained=True)
    tcarry, tstats, tr = trt.run_fused(12, tbody,
                                       torch.zeros(4, dtype=torch.int32),
                                       until_drained=True)
    assert 0 < tr == jr < 12
    assert_same(np.asarray(jcarry), tcarry, "carry")
    assert tstats.n_transferred.shape == (tr,)
    _assert_runtimes_equal(jrt, trt)
    # already drained: no round runs and nothing changes
    jc2, _, jr2 = jrt.run_fused(3, jbody, jnp.zeros(4, jnp.int32),
                                until_drained=True)
    tc2, _, tr2 = trt.run_fused(3, tbody, torch.zeros(4, dtype=torch.int32),
                                until_drained=True)
    assert jr2 == tr2 == 0
    assert_same(np.asarray(jc2), tc2, "carry after drain")
    _assert_runtimes_equal(jrt, trt)


@pytest.mark.parametrize("fused", [1, 4])
def test_run_with_worker_body_matches_reference(fused):
    sizes = [30, 0, 2, 0]
    jrt, trt = _pair(sizes, POLICY)
    jbody, tbody = _bodies(jrt, trt)
    jcarry = jrt.run(jbody, jnp.zeros(4, jnp.int32), fused=fused)
    tcarry = trt.run(tbody, torch.zeros(4, dtype=torch.int32), fused=fused)
    assert_same(np.asarray(jcarry), tcarry, "carry")
    _assert_runtimes_equal(jrt, trt)


def test_push_and_drain_match_reference():
    jrt, trt = _pair([5, 0, 3], POLICY, adaptive=False)
    jlanes, tlanes = jrt.drain(), trt.drain()
    assert [[int(x) for x in lane] for lane in jlanes] == \
        [[int(x) for x in lane] for lane in tlanes]
    assert to_numpy(trt.queues.size).tolist() == [0, 0, 0]
    _assert_runtimes_equal(jrt, trt)
