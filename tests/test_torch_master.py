"""The port's virtual master (``repro_torch.core.master.superstep`` on
stacked lanes) against the JAX package's vmapped superstep
(``repro.core.sharded_queue.vmapped_superstep``): random size vectors,
wrapped rings, proportions and both exchanges, on the reference and kernel
backends.  Queues and every ``RebalanceStats`` field must be bit-identical
(the JAX stats hold one replicated copy per lane; the port holds one).
Also the ``plan=`` hook, ``plan_transfers`` with ties, and ``donate``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.master import superstep as jax_superstep
from repro.core.policy import StealPolicy as JaxPolicy
from repro.core.policy import plan_transfers as jax_plan_transfers
from repro.core.sharded_queue import vmapped_superstep
from repro_torch.core import ops as tops
from repro_torch.core.master import RebalanceStats, superstep
from repro_torch.core.policy import StealPolicy, plan_transfers

from _torch_parity import assert_same, tree_np, one_torch_thread  # noqa: F401

CAP = 128


def _state(rng, sizes):
    """Stacked numpy state: unique ids in every lane's live rows (from a
    random ``lo``, so rings wrap), random payload elsewhere."""
    w = len(sizes)
    ids = rng.integers(10 ** 6, 2 * 10 ** 6, (w, CAP)).astype(np.int32)
    aux = rng.integers(-100, 100, (w, CAP, 2)).astype(np.int32)
    lo = rng.integers(0, CAP, w).astype(np.int32)
    nxt = 1
    for l, n in enumerate(sizes):
        ids[l, (lo[l] + np.arange(n)) % CAP] = np.arange(nxt, nxt + n)
        nxt += n
    return tops.QueueState({"id": ids, "aux": aux}, lo,
                           np.asarray(sizes, np.int32))


def _case(seed):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([4, 8]))
    sizes = rng.choice([0, 0, 1, 3, 9, 40, 100, CAP], w)
    kw = dict(proportion=float(rng.choice([0.3, 0.5, 0.65])),
              low_watermark=int(rng.integers(0, 3)),
              high_watermark=int(rng.integers(4, 10)),
              max_steal=int(rng.choice([16, 32, 64])))
    return rng, _state(rng, sizes), kw


def _jax_state(q):
    return jops.QueueState({k: jnp.asarray(v) for k, v in q.buf.items()},
                           jnp.asarray(q.lo), jnp.asarray(q.size))


@functools.lru_cache(maxsize=None)
def _jax_rounds(seed, exchange, rounds=2):
    """The JAX package's states and stats after each of ``rounds``
    supersteps (cached: both port backends compare against it)."""
    _, q, kw = _case(seed)
    step = vmapped_superstep(JaxPolicy(exchange=exchange, **kw))
    qs, out = _jax_state(q), []
    for _ in range(rounds):
        qs, stats = step(qs)
        out.append((tree_np(qs), tree_np(stats)))
    return out


def _assert_stats(jstats, tstats, what):
    """Port stats (one value) against the JAX package's per-lane copies."""
    for f in RebalanceStats._fields:
        lanes = np.asarray(getattr(jstats, f))
        assert (lanes == lanes[0]).all(), f"{what}: {f} not replicated"
        assert_same(lanes[0], getattr(tstats, f), f"{what}: {f}")
    for f in ("n_transferred_xpod", "n_steals_xpod", "bytes_moved_xpod"):
        assert not np.asarray(getattr(jstats, f)).any()


def _assert_queue(jq, tq, what):
    for k in jq.buf:
        assert_same(jq.buf[k], tq.buf[k], f"{what}: ring {k}")
    assert_same(jq.lo, tq.lo, f"{what}: lo")
    assert_same(jq.size, tq.size, f"{what}: size")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("exchange", ["compact", "dense"])
@pytest.mark.parametrize("seed", range(4))
def test_superstep_matches_vmapped_reference(seed, exchange, backend):
    _, q, kw = _case(seed)
    policy = StealPolicy(exchange=exchange, backend=backend, **kw)
    tq = tops.queue_from_numpy(q, device="cpu")
    for r, (jq, jstats) in enumerate(_jax_rounds(seed, exchange)):
        tq, tstats = superstep(tq, policy, donate=r % 2 == 1)
        _assert_queue(jq, tq, f"round {r}")
        _assert_stats(jstats, tstats, f"round {r}")


@pytest.mark.parametrize("exchange", ["compact", "dense"])
def test_balanced_round_moves_nothing(exchange):
    """A round with no (victim, thief) pair leaves the state bit-identical
    (the compact exchange launches its kernels all the same) and accounts
    the exchange payload as the JAX package does."""
    q = _state(np.random.default_rng(0), [4, 5, 4, 5])
    kw = dict(proportion=0.5, low_watermark=1, high_watermark=6,
              max_steal=16)
    jq, jstats = tree_np(vmapped_superstep(
        JaxPolicy(exchange=exchange, **kw))(_jax_state(q)))
    tq, tstats = superstep(tops.queue_from_numpy(q, device="cpu"),
                           StealPolicy(exchange=exchange, backend="cuda",
                                       **kw))
    _assert_queue(jq, tq, exchange)
    _assert_stats(jstats, tstats, exchange)
    for k in q.buf:
        np.testing.assert_array_equal(tops.to_numpy(tq.buf[k]), q.buf[k])
    item_bytes = 3 * 4
    assert int(tstats.bytes_moved) == (0 if exchange == "compact"
                                       else 4 * 16 * item_bytes)


@pytest.mark.parametrize("exchange", ["compact", "dense"])
def test_plan_hook_matches_reference(exchange):
    """An externally supplied plan (a dead lane drained at proportion 1.0,
    the resilience layer's use) runs through the same exchange."""
    sizes = [30, 0, 7, 50, 0, 2]
    q = _state(np.random.default_rng(3), sizes)
    plan = np.stack([np.arange(6), np.zeros(6)], -1).astype(np.int32)
    plan[1] = (3, 50)   # lane 1 takes all of lane 3
    plan[4] = (0, 20)   # lane 4 takes 20 of lane 0
    kw = dict(proportion=0.5, low_watermark=0, high_watermark=4,
              max_steal=64)
    jstep = jax.jit(jax.vmap(
        functools.partial(jax_superstep, policy=JaxPolicy(exchange=exchange,
                                                          **kw),
                          axis_name="w", plan=jnp.asarray(plan)),
        axis_name="w"))
    jq, jstats = tree_np(jstep(_jax_state(q)))
    for backend in ("reference", "cuda"):
        tq, tstats = superstep(
            tops.queue_from_numpy(q, device="cpu"),
            StealPolicy(exchange=exchange, backend=backend, **kw),
            plan=torch.as_tensor(plan))
        _assert_queue(jq, tq, backend)
        _assert_stats(jstats, tstats, backend)


def test_plan_transfers_matches_reference_with_ties():
    rng = np.random.default_rng(11)
    for _ in range(40):
        w = int(rng.choice([5, 16]))
        sizes = rng.choice([0, 0, 1, 2, 5, 5, 9, 9, 17, 300], w).astype(
            np.int32)
        kw = dict(proportion=float(rng.choice([0.1, 0.3, 0.35, 0.5, 0.6])),
                  queue_limit=int(rng.integers(1, 4)),
                  low_watermark=int(rng.integers(0, 3)),
                  high_watermark=int(rng.integers(3, 10)),
                  max_steal=int(rng.choice([4, 16, 256])))
        want = np.asarray(jax_plan_transfers(jnp.asarray(sizes),
                                             JaxPolicy(**kw)))
        got = plan_transfers(torch.as_tensor(sizes), StealPolicy(**kw))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy(), err_msg=str(kw))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_superstep_donate(backend):
    """``donate=False`` leaves the input state untouched; ``donate=True``
    splices into its ring tensors and gives the same result."""
    q = _state(np.random.default_rng(5), [60, 0, 0, 33, 1, 0])
    policy = StealPolicy(proportion=0.5, low_watermark=1, high_watermark=4,
                         max_steal=32, backend=backend)
    for exchange in ("compact", "dense"):
        pol = dataclasses.replace(policy, exchange=exchange)
        tq = tops.queue_from_numpy(q, device="cpu")
        pure, _ = superstep(tq, pol)
        for k in q.buf:
            np.testing.assert_array_equal(tops.to_numpy(tq.buf[k]), q.buf[k])
        inplace, _ = superstep(tq, pol, donate=True)
        for k in q.buf:
            assert inplace.buf[k] is tq.buf[k]
            assert torch.equal(inplace.buf[k], pure.buf[k])
        assert not np.array_equal(tops.to_numpy(tq.buf["id"]), q.buf["id"])
