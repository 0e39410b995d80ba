"""The port's host data pipeline (``repro_torch.data``) against the JAX
package's (``repro.data``), on the cases of ``tests/test_data.py``:
deterministic synthetic batches, exact resume, a pipeline that serves
every task once, and the master's bulk steal moving tasks between host
queues — with the straggler monitor switched off, the same tasks in the
same order as the JAX package's pipeline."""

import numpy as np
import pytest

from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro_torch.data.pipeline import WorkStealingPipeline
from repro_torch.data.synthetic import SynthDataset, synth_batch

from _torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("seed", range(3))
def test_synth_batch_is_deterministic_and_equal_to_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        args = (int(rng.integers(0, 100)), int(rng.integers(0, 8)),
                int(rng.integers(0, 50)), int(rng.integers(1, 5)),
                int(rng.integers(1, 32)), int(rng.integers(2, 5000)))
        a, b = synth_batch(*args), synth_batch(*args)
        want = jsynthetic.synth_batch(*args)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], want[k])
    a = synth_batch(7, 3, 11, 4, 16, 1000)
    c = synth_batch(7, 3, 12, 4, 16, 1000)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_dataset_state_resume():
    ds = SynthDataset(seed=1, shard=0, n_shards=4, batch=2, seq=8, vocab=100)
    jds = jsynthetic.SynthDataset(seed=1, shard=0, n_shards=4, batch=2,
                                  seq=8, vocab=100)
    for _ in range(5):
        ds.next()
        jds.next()
    state = ds.state()
    assert state == jds.state()
    next_a = ds.next()
    ds2 = SynthDataset.from_state(state, n_shards=4, batch=2, seq=8,
                                  vocab=100)
    np.testing.assert_array_equal(next_a["tokens"], ds2.next()["tokens"])
    np.testing.assert_array_equal(next_a["tokens"], jds.next()["tokens"])


def _no_stragglers(pipe):
    for q in pipe.queues:
        q.monitor.threshold = float("inf")
    return pipe


def test_pipeline_serves_every_task_once_as_the_jax_package_does():
    seen, j_seen = [], []
    pipe = _no_stragglers(WorkStealingPipeline(
        n_hosts=3, make_batch=lambda shard, step: seen.append((shard, step))
        or {"shard": shard, "step": step}, prefetch=8))
    jpipe = _no_stragglers(jpipeline.WorkStealingPipeline(
        n_hosts=3, make_batch=lambda shard, step: j_seen.append((shard, step))
        or {"shard": shard, "step": step}, prefetch=8))
    for i in range(30):
        assert pipe.next_batch(i % 3) == jpipe.next_batch(i % 3)
    assert len(seen) == 30 and len(set(seen)) == 30
    assert seen == j_seen
    assert pipe.stats() == jpipe.stats()


@pytest.mark.parametrize("slow,fast", [([0], [1]), ([1], [0, 2]),
                                       ([0, 2], [1])])
def test_master_steal_moves_tasks_as_the_jax_package_does(slow, fast):
    n = 1 + max(slow + fast)
    pipe = WorkStealingPipeline(n_hosts=n, make_batch=lambda s, t: {},
                                prefetch=16)
    jpipe = jpipeline.WorkStealingPipeline(n_hosts=n,
                                           make_batch=lambda s, t: {},
                                           prefetch=16)
    for p in (pipe, jpipe):
        for q in p.queues:
            q.refill()
    before = [len(q.q) for q in pipe.queues]
    moved = pipe.master.rebalance(slow=slow, fast=fast)
    assert moved == jpipe.master.rebalance(slow=slow, fast=fast) > 0
    after = [len(q.q) for q in pipe.queues]
    assert sum(before) == sum(after), "the steal lost or duplicated tasks"
    assert all(after[s] < before[s] for s in slow)
    for q, jq in zip(pipe.queues, jpipe.queues):
        assert q.q.drain() == jq.q.drain()
    assert pipe.master.rebalance(slow=[], fast=fast) == 0


def test_straggler_triggers_a_rebalance():
    pipe = WorkStealingPipeline(n_hosts=2, make_batch=lambda s, t: (s, t),
                                prefetch=8)
    mon = pipe.queues[0].monitor
    mon.observe = lambda: True  # every step of host 0 is slow
    pipe.queues[1].refill()
    pipe.next_batch(0)
    assert pipe.master.rounds == 1 and pipe.master.stolen_total > 0
