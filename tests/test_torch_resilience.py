"""The port's resilience layer (``repro_torch.runtime.resilience`` and the
fault-aware ``StealRuntime``) against the JAX package's under vmap on the
CPU: the Fig. 9 DAG drained under a kill / delay / drop plan must give the
same per-lane carry, rounds, telemetry summary, proportion history, sizes
and rings, bit for bit; the replicated plans (``masked_plan``,
``recovery_plan``), the re-stated ``FaultPlan`` and the host controls
(``kill_lane``, ``revive_lane``, ``note_straggler``) must agree too."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import StealPolicy as JaxPolicy
from repro.runtime import FaultPlan as JaxFaultPlan
from repro.runtime import resilience as jres
from repro_torch.core.policy import StealPolicy
from repro_torch.runtime import FaultPlan, FaultState, StealRuntime
from repro_torch.runtime import resilience as tres

from _torch_fault import (CAP, FLAT_PLAN, MAX_STEAL, POLICY, SPEC, W,
                          assert_same_run, items_of, jax_runtime,
                          port_runtime, run_jax_dag, run_port_dag)
from _torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_flat_replay():
    return run_jax_dag(FLAT_PLAN)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_flat_fault_replay_matches_reference(jax_flat_replay, backend):
    """Lane 3 dies at round 6 mid-drain, lane 5 skips rounds 4-7, round
    8's exchange is dropped: every node is still explored exactly once,
    dead lanes end empty, and everything equals the JAX package's run."""
    port = run_port_dag(FLAT_PLAN, backend=backend)
    assert_same_run(jax_flat_replay, port, backend)
    assert port[0].dead_lanes().tolist() == [w == 3 for w in range(W)]


def test_unarmed_runtime_matches_reference():
    """Without a plan the round is the unarmed one, still equal."""
    assert_same_run(run_jax_dag(), run_port_dag())


def test_empty_plan_changes_nothing_but_the_launches():
    """An armed runtime with nothing scheduled drains as the unarmed one
    (its recovery supersteps move nothing)."""
    armed, plain = run_port_dag({}), run_port_dag()
    assert armed[1].tolist() == plain[1].tolist() and armed[2] == plain[2]
    assert armed[0].controller.history == plain[0].controller.history
    for a, b in zip(armed[0].queues, plain[0].queues):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_random_is_the_reference_plan(seed):
    kw = dict(n_kills=1 + seed % 3, n_delays=seed % 2, n_drops=seed % 3)
    want = JaxFaultPlan.random(8, seed=seed, **kw)
    got = FaultPlan.random(8, seed=seed, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    js, ts = jres.FaultState(want, 8), FaultState(got, 8)
    for key, arr in js.state_dict().items():
        np.testing.assert_array_equal(ts.state_dict()[key], arr)
    for r in range(20):
        np.testing.assert_array_equal(ts.dead_at(r), js.dead_at(r))


def test_fault_plan_validation():
    for bad in (FaultPlan(kills=((8, 1),)), FaultPlan(kills=((0, -1),)),
                FaultPlan(delays=((1, 2, 0),)),
                FaultPlan(kills=tuple((w, 1) for w in range(4)))):
        with pytest.raises(ValueError):
            bad.validate(4)
    with pytest.raises(ValueError, match="every lane"):
        FaultPlan.random(4, seed=0, n_kills=4)
    # the dead-lane sentinel must be neither idle nor a victim
    with pytest.raises(ValueError, match="low_watermark"):
        StealRuntime(4, 16, SPEC, device="cpu", fault_plan=FaultPlan(),
                     policy=StealPolicy(low_watermark=4, high_watermark=5))


def test_fault_context_is_the_schedule():
    st = FaultState(FaultPlan(kills=((1, 2),), delays=((2, 1, 2),),
                              drops=(3,)), 4)
    ctx = st.ctx(1, 3, device="cpu")
    assert ctx.dead.tolist() == [[r >= 2 and w == 1 for w in range(4)]
                                 for r in range(1, 5)]
    assert ctx.skip.tolist() == [
        [(w == 1 and r >= 2) or (w == 2 and r in (1, 2)) for w in range(4)]
        for r in range(1, 4)]
    assert ctx.drop.tolist() == [False, False, True]
    assert ctx.skip_at == (0, 1, 3, 4)
    assert ctx.skip_idx.tolist() == [2, 1, 2, 1]
    assert [None if r.skip_idx is None else r.skip_idx.tolist()
            for r in map(ctx.round, range(3))] == [[2], [1, 2], [1]]
    assert st.ctx(5, 2, device="cpu").round(0).skip_idx.tolist() == [1]
    assert FaultState(FaultPlan(), 4).ctx(0, 2).round(1).skip_idx is None


def _plan_inputs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.choice([4, 8, 16]))
    sizes = rng.choice([0, 0, 1, 3, 5, 9, 40, 100, CAP], n).astype(np.int32)
    dead = rng.random(n) < 0.35
    dead[int(rng.integers(0, n))] = False
    thief_ok = rng.random(n) < 0.7
    return sizes, dead, thief_ok


@pytest.mark.parametrize("seed", range(8))
def test_recovery_and_masked_plans_match_reference(seed):
    sizes, dead, thief_ok = _plan_inputs(seed)
    ts, td, tok = map(torch.from_numpy, (sizes, dead, thief_ok))
    js, jd, jok = map(jnp.asarray, (sizes, dead, thief_ok))
    for ms in (8, 64):
        for ok in (None, True):
            want = jres.recovery_plan(js, jd, max_steal=ms, capacity=CAP,
                                      thief_ok=jok if ok else None)
            got = tres.recovery_plan(ts, td, max_steal=ms, capacity=CAP,
                                     thief_ok=tok if ok else None)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for p in (0.3, 0.5, 1.0):
        kw = dict(POLICY, proportion=p)
        want = jres.masked_plan(js, jd, JaxPolicy(**kw))
        got = tres.masked_plan(ts, td, StealPolicy(**kw))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tres.mask_sizes(ts, td, StealPolicy(**POLICY)).numpy(),
        np.where(dead, POLICY["low_watermark"] + 1, sizes))


def test_batched_recovery_plan_is_per_group():
    """Planned over (G, L) at once, each group gets its own plan."""
    rng = np.random.default_rng(3)
    sizes = torch.from_numpy(rng.choice([0, 1, 5, 40, CAP], (3, 8))
                             .astype(np.int32))
    dead = torch.from_numpy(rng.random((3, 8)) < 0.4)
    ok = torch.from_numpy(rng.random((3, 8)) < 0.7)
    got = tres.recovery_plan(sizes, dead, max_steal=64, capacity=CAP,
                             thief_ok=ok)
    for g in range(3):
        np.testing.assert_array_equal(
            got[g].numpy(),
            tres.recovery_plan(sizes[g], dead[g], max_steal=64, capacity=CAP,
                               thief_ok=ok[g]).numpy())


def _seeded(rt, rng_seed=7, jax_side=False):
    rng = np.random.default_rng(rng_seed)
    for w in range(W):
        n = int(rng.integers(10, 40))
        ids = np.arange(w * 100, w * 100 + n, dtype=np.int32)
        rt.push(w, jnp.asarray(ids) if jax_side else torch.from_numpy(ids), n)


def test_kill_revive_and_straggler_controls_match_reference():
    """Live kills and revivals between rounds, and a straggler boost, drive
    both packages to the same queues, history and fault log."""
    pol = dict(low_watermark=2, high_watermark=16)
    jrt, trt = jax_runtime({}, policy=pol), port_runtime({}, policy=pol)
    _seeded(jrt, jax_side=True)
    _seeded(trt)
    before = items_of(trt)
    for rt in (jrt, trt):
        rt.kill_lane(2)
        rt.kill_lane(5, at_round=2)
        with pytest.raises(ValueError, match="already dead"):
            rt.kill_lane(2)
        rt.round()
        rt.note_straggler(rounds=2, factor=1.5, lane=1)
        rt.round()
        rt.round()
        rt.revive_lane(2)
        for _ in range(3):
            rt.round()
    assert trt.dead_lanes().tolist() == np.asarray(jrt.dead_lanes()).tolist()
    assert trt.controller.history == jrt.controller.history
    assert trt.telemetry.summary() == jrt.telemetry.summary()
    assert trt.telemetry.fault_log == jrt.telemetry.fault_log
    assert items_of(trt) == items_of(jrt) == before
    assert trt.sizes()[5] == 0


def test_fault_layer_required_for_live_kills():
    rt = port_runtime()
    with pytest.raises(RuntimeError, match="fault layer not armed"):
        rt.kill_lane(1)
    assert not rt.dead_lanes().any()


@pytest.mark.parametrize("pod_size", [None, 4])
def test_fault_replay_under_the_sanitizer_matches_the_unchecked_run(
        pod_size):
    """Every op of every round checked lane by lane (and each exchange
    level's sizes conserved): no violation, and the same drain."""
    from repro_torch.analysis import sanitize
    from repro_torch.core.ops import make_ops

    from _torch_fault import N_NODES, drain, torch_dag_body

    sanitize.reset_violations()
    plain = run_port_dag(FLAT_PLAN, pod_size)
    rt = StealRuntime(W, CAP, SPEC, policy=StealPolicy(**POLICY),
                      backend=make_ops("cuda", check=True),
                      pod_size=pod_size, fault_plan=FaultPlan(**FLAT_PLAN),
                      device="cpu")
    assert rt._check
    rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    carry, rounds = drain(rt, torch_dag_body(rt.ops),
                          torch.zeros((W,), dtype=torch.int32))
    assert sanitize.violations() == ()
    assert int(carry.sum()) == N_NODES and rounds == plain[2]
    assert carry.tolist() == plain[1].tolist()
    assert rt.telemetry.summary() == plain[0].telemetry.summary()
