"""Two-level rounds on stacked lanes against the JAX package's nested
vmap: ``hierarchical_superstep`` on seeded states with every
``RebalanceStats`` field, the probe prefix, the unarmed hierarchical
runtime, the dead-lane and the dead-pod fault replays on pods of 2 x 4,
and the failure detector turning a delay schedule into kills at the same
rounds as the JAX package, flat and in pods."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import master as jmaster
from repro.core.policy import StealPolicy as JaxPolicy
from repro.runtime import DetectorPolicy as JaxDetectorPolicy
from repro.runtime.telemetry import reduce_round_stats as jax_reduce
from repro_torch.core import master as tmaster
from repro_torch.core import ops as tops
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime import DetectorPolicy
from repro_torch.runtime.telemetry import reduce_round_stats

from _torch_fault import (DEAD_POD_PLAN, FLAT_PLAN, POD, W, assert_same_run,
                          items_of, jax_runtime, port_runtime, run_jax_dag,
                          run_port_dag)
from _torch_parity import assert_same, one_torch_thread  # noqa: F401
from test_torch_master import CAP, _jax_state, _state


def _hier_case(seed, exchange):
    rng = np.random.default_rng(seed)
    pods, per = [(2, 4), (4, 2), (2, 2), (2, 8)][seed % 4]
    sizes = rng.choice([0, 0, 1, 3, 9, 40, 100, CAP], pods * per)
    kw = dict(proportion=float(rng.choice([0.3, 0.5, 0.65])),
              low_watermark=int(rng.integers(0, 3)),
              high_watermark=int(rng.integers(4, 10)),
              max_steal=int(rng.choice([16, 32, 64])), exchange=exchange)
    return pods, per, _state(rng, sizes), kw


@functools.lru_cache(maxsize=None)
def _jax_hier(seed, exchange):
    """The JAX package's hierarchical superstep over a (pods, per) grid of
    nested vmaps, jitted (cached: both port backends compare with it)."""
    pods, per, q, kw = _hier_case(seed, exchange)
    jpol = JaxPolicy(backend="reference", **kw)
    f = jax.jit(jax.vmap(jax.vmap(
        lambda x: jmaster.hierarchical_superstep(
            x, jpol, worker_axis="w", pod_axis="p"),
        axis_name="w"), axis_name="p"))
    jq, js = f(jax.tree_util.tree_map(
        lambda x: x.reshape((pods, per) + x.shape[1:]), _jax_state(q)))
    w = pods * per
    jq = jax.tree_util.tree_map(
        lambda x: np.asarray(x).reshape((w,) + x.shape[2:]), jq)
    return jq, jax.tree_util.tree_map(np.asarray, js)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("exchange", ["compact", "dense"])
@pytest.mark.parametrize("seed", range(6))
def test_hierarchical_superstep_matches_nested_vmap(seed, exchange, backend):
    pods, per, q, kw = _hier_case(seed, exchange)
    jq, js = _jax_hier(seed, exchange)
    w = pods * per
    tq, ts = tmaster.hierarchical_superstep(
        tops.queue_from_numpy(q, device="cpu"),
        StealPolicy(backend=backend, **kw), pod_size=per)
    for k in jq.buf:
        assert_same(jq.buf[k], tq.buf[k], f"ring {k}")
    assert_same(jq.lo, tq.lo, "lo")
    assert_same(jq.size, tq.size, "size")
    # intra-pod counters: replicated within a pod, one per pod here
    for f in ("n_transferred", "n_steals", "bytes_moved"):
        lanes = getattr(js, f)
        assert (lanes == lanes[:, :1]).all(), f
        assert_same(lanes[:, 0], getattr(ts, f), f)
    # cross-pod counters: lane (p, 0)'s value, the same in every pod
    for f in ("n_transferred_xpod", "n_steals_xpod", "bytes_moved_xpod"):
        lanes = getattr(js, f)
        assert (lanes[:, 0] == lanes[0, 0]).all(), f
        if f != "bytes_moved_xpod" or exchange == "compact":
            assert not lanes[:, 1:].any(), f
        assert_same(lanes[0, 0], getattr(ts, f), f)
    # sizes: every lane holds its pod's slice before, and lane l the
    # pod-level gather of row l after (lane 0: the representatives' sizes)
    before = ts.sizes_before.reshape(pods, 1, per).expand(pods, per, per)
    assert_same(js.sizes_before, before, "sizes_before")
    assert_same(js.sizes_after[0, 0], ts.sizes_after.reshape(pods, per)[:, 0],
                "sizes_after")
    assert_same(jq.size, ts.sizes_after, "sizes_after is the size vector")
    # the one exact reduction, from either package's stats
    host = type(ts)(*(np.asarray(x) for x in ts))
    per_lane = jax.tree_util.tree_map(lambda x: x.reshape(w, -1), js)
    assert reduce_round_stats(host, n_workers=w, pod_size=per) == \
        jax_reduce(per_lane, n_workers=w, pod_size=per) == \
        reduce_round_stats(per_lane, n_workers=w, pod_size=per)


@pytest.mark.parametrize("seed", range(4))
def test_exchange_probe_matches_reference(seed):
    """The probe prefix: the same tokens per lane, the state untouched."""
    _, _, q, kw = _hier_case(seed, "compact")
    jtok = jax.jit(jax.vmap(lambda x: jmaster.exchange_probe(
        x, JaxPolicy(backend="reference", **kw), axis_name="w"),
        axis_name="w"))(_jax_state(q))
    tq = tops.queue_from_numpy(q, device="cpu")
    ring = tq.buf["id"].clone()
    for backend in ("reference", "cuda"):
        tok = tmaster.exchange_probe(tq, StealPolicy(backend=backend, **kw))
        assert_same(np.asarray(jtok), tok, backend)
    assert torch.equal(tq.buf["id"], ring)
    assert_same(np.asarray(jax.vmap(jmaster.probe_token)(_jax_state(q))),
                tmaster.probe_token(tq), "probe_token")


def test_level_views_are_inverse():
    lv = tmaster.Level(12, 3, across=True)
    v = torch.arange(12)
    assert lv.view(v).tolist() == [[0, 3, 6, 9], [1, 4, 7, 10],
                                   [2, 5, 8, 11]]
    assert torch.equal(lv.unview(lv.view(v)), v)
    plan = torch.tensor([[[1, 5], [1, 0], [2, 0], [3, 0]]] * 3,
                        dtype=torch.int32)
    src, amt = lv.global_plan(plan)
    assert src.reshape(4, 3).T.tolist()[0] == [3, 3, 6, 9]
    assert amt.tolist()[:3] == [5, 5, 5]
    with pytest.raises(ValueError, match="divisible"):
        tmaster.hierarchical_superstep(
            tops.make_queue(4, torch.zeros((), dtype=torch.int32),
                            device="cpu")._replace(
                size=torch.zeros(6, dtype=torch.int32),
                lo=torch.zeros(6, dtype=torch.int32)),
            StealPolicy(), pod_size=4)


def test_unarmed_hierarchical_runtime_matches_reference():
    assert_same_run(run_jax_dag(pod_size=POD), run_port_dag(pod_size=POD))


PLANS = {"dead-lane": FLAT_PLAN, "dead-pod": DEAD_POD_PLAN}


@functools.lru_cache(maxsize=None)
def _jax_replay(name):
    return run_jax_dag(PLANS[name], pod_size=POD)


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_hierarchical_fault_replay_matches_reference(name, backend):
    """A dead lane drains within its pod; a dead pod drains across pods."""
    port_run = run_port_dag(PLANS[name], pod_size=POD, backend=backend)
    assert_same_run(_jax_replay(name), port_run, name)
    if name == "dead-pod":
        assert port_run[0].dead_lanes()[POD:].all()


@pytest.mark.parametrize("pod_size", [None, POD])
def test_detector_converts_delays_into_the_reference_kills(pod_size):
    """A delay schedule crosses ``dead_after``: the detector kills both
    delayed lanes at the same rounds as the JAX package's, and their
    rings drain through recovery with no item lost."""
    pol = dict(low_watermark=4, high_watermark=16)
    plan = dict(delays=((2, 1, 10), (6, 3, 10)))
    runs = []
    for rt, det_pol, arr in (
            (jax_runtime(plan, pod_size, pol), JaxDetectorPolicy,
             jnp.asarray),
            (port_runtime(plan, pod_size, "reference", pol), DetectorPolicy,
             torch.from_numpy)):
        det = rt.attach_detector(det_pol(suspect_after=2, dead_after=4))
        rng = np.random.default_rng(7)
        for w in range(W):
            n = int(rng.integers(10, 40))
            rt.push(w, arr(np.arange(w * 100, w * 100 + n, dtype=np.int32)),
                    n)
        before = items_of(rt)
        for _ in range(14):
            rt.round()
        assert det.state(2) == "dead" and det.state(6) == "dead"
        assert rt.telemetry.fault_events["auto_kill"] == 2
        assert rt.sizes()[2] == 0 and rt.sizes()[6] == 0
        assert items_of(rt) == before
        runs.append((np.asarray(rt.fault.kill_round).tolist(), det.states(),
                     rt.telemetry.summary(), rt.controller.history,
                     np.asarray(rt.sizes()).tolist()))
    assert runs[0] == runs[1]
