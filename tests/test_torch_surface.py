"""The JAX package's public names in the port, held against the JAX package
on the CPU: the vmapped superstep, the round's one definition
(``make_lane_step`` / ``make_resilient_lane``) against the runtime's own
rounds, the fault context's helpers, ``layers.cross_entropy`` and the
smaller names (queue size, the kernels' geometry predicates, item bytes,
the production pod, the roofline's cost-analysis readers).
``sharded_superstep`` runs on 8 gloo ranks in
``tests/test_torch_distributed.py``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.policy import StealPolicy as JaxPolicy
from repro.core.sharded_queue import vmapped_superstep as jax_vmapped
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import layers as jlayers
from repro.runtime import resilience as jres
from repro.runtime import telemetry as jtelemetry
from repro_torch.core import ops as tops
from repro_torch.core.master import RebalanceStats
from repro_torch.core.policy import StealPolicy
from repro_torch.core.sharded_queue import vmapped_superstep
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troofline
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.runtime import resilience as tres
from repro_torch.runtime import telemetry as ttelemetry
from repro_torch.runtime.executor import StealRuntime, make_lane_step
from repro_torch.train.trainer import TrainState

from _torch_parity import one_torch_thread  # noqa: F401

W, CAP = 8, 64
POLICY = dict(proportion=0.5, low_watermark=2, high_watermark=8,
              max_steal=32)


def _seeded_lanes(seed: int):
    """W seeded rings: random int32 payload, cursors anywhere in the ring
    (segments that wrap among them), sizes with empty and loaded lanes."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(-2 ** 30, 2 ** 30, (W, CAP)).astype(np.int32)
    lo = rng.integers(0, CAP, W).astype(np.int32)
    size = rng.choice([0, 0, 1, 3, 9, 20, 40, CAP], W).astype(np.int32)
    return buf, lo, size


@pytest.mark.parametrize("exchange", ["compact", "dense"])
@pytest.mark.parametrize("seed", range(3))
def test_vmapped_superstep_equals_the_jax_package(exchange, seed):
    """Two supersteps of each package's ``vmapped_superstep`` on the same
    lanes: rings, cursors and every stats field (a copy per lane) bit for
    bit; the input lanes are left as they were, and a superstep made for
    another device refuses them."""
    buf, lo, size = _seeded_lanes(seed)
    jq = jops.QueueState(jnp.asarray(buf), jnp.asarray(lo),
                         jnp.asarray(size))
    tq = tops.QueueState(torch.from_numpy(buf.copy()), torch.from_numpy(lo),
                         torch.from_numpy(size))
    jstep = jax_vmapped(JaxPolicy(exchange=exchange, **POLICY),
                        ops=jops.make_ops("reference"))
    tstep = vmapped_superstep(StealPolicy(exchange=exchange, **POLICY),
                              device="cpu")
    for turn in range(2):
        jq, jstats = jstep(jq)
        tq_new, tstats = tstep(tq)
        if turn == 0:   # the input lanes are left as they were
            assert np.array_equal(tops.to_numpy(tq.buf), buf)
            assert np.array_equal(tops.to_numpy(tq.size), size)
        for f in RebalanceStats._fields:
            want = np.asarray(getattr(jstats, f))
            got = tops.to_numpy(getattr(tstats, f))
            assert got.dtype == want.dtype and got.shape == want.shape, f
            np.testing.assert_array_equal(got, want, err_msg=f)
        for got, want in ((tq_new.buf, jq.buf), (tq_new.lo, jq.lo),
                          (tq_new.size, jq.size)):
            np.testing.assert_array_equal(tops.to_numpy(got),
                                          np.asarray(want))
        tq = tq_new
    with pytest.raises(ValueError, match="made for"):
        vmapped_superstep(StealPolicy(**POLICY), device="meta")(tq)


@pytest.mark.parametrize("pod_size", [None, 4])
@pytest.mark.parametrize("fault", [False, True])
def test_make_lane_step_is_the_runtime_round(pod_size, fault):
    """``make_lane_step`` (``make_resilient_lane`` with ``fault=True``) on
    a copy of a runtime's lanes gives the queues and stats of the
    runtime's own round."""
    plan = tres.FaultPlan(kills=((3, 0),), drops=(1,)) if fault else None
    rt = StealRuntime(W, CAP, torch.zeros((), dtype=torch.int32),
                      device="cpu", pod_size=pod_size, fault_plan=plan,
                      policy=StealPolicy(**POLICY))
    buf, lo, size = _seeded_lanes(7)
    rt.queues = tops.QueueState(torch.from_numpy(buf), torch.from_numpy(lo),
                                torch.from_numpy(size))
    for r in range(2):
        q = tops.QueueState(rt.queues.buf.clone(), rt.queues.lo.clone(),
                            rt.queues.size.clone())
        carry = torch.zeros((W,), dtype=torch.int32)
        step = make_lane_step(rt.policy, rt.ops, None, pod_size=pod_size,
                              fault=fault)
        faults = (rt.fault.ctx(r, 1, device="cpu").round(0) if fault
                  else None)
        q, _, stats = step(q, carry, rt._p(), faults)
        _, want = rt.round()
        for got, exp in zip((q.buf, q.lo, q.size, *stats),
                            (*rt.queues, *want)):
            np.testing.assert_array_equal(tops.to_numpy(torch.as_tensor(got)),
                                          tops.to_numpy(torch.as_tensor(exp)))
    assert tres.make_resilient_lane.__name__ == "make_resilient_lane"


@pytest.mark.parametrize("seed", range(4))
def test_fault_context_helpers_equal_the_jax_package(seed):
    """``ctx_round``, ``ctx_advance`` and ``dead_mask`` on a block's
    context and on its rounds, against the JAX package's on its context
    of the same ``FaultPlan``, round by round; with the fault layer off
    the context is the round index in both."""
    kw = dict(seed=seed, n_kills=3, n_delays=2, n_drops=2, max_round=10)
    jst = jres.FaultState(jres.FaultPlan.random(W, **kw), W)
    tst = tres.FaultState(tres.FaultPlan.random(W, **kw), W)
    assert np.array_equal(jst.kill_round, tst.kill_round)
    tctx = tst.ctx(0, 12, device="cpu")
    jctx = jst.ctx(0)
    for r in range(12):
        want = np.asarray(jres.dead_mask(jctx))
        assert tres.ctx_round(tctx) == int(jres.ctx_round(jctx)) == r
        assert tres.ctx_round(tctx.round(0)) == r
        assert tres.dead_mask(tctx).tolist() == want.tolist()
        assert tres.dead_mask(tctx.round(0)).tolist() == want.tolist()
        assert tres.dead_mask(tst.ctx(0, 12, device="cpu").round(r)
                              ).tolist() == want.tolist()
        tctx, jctx = tres.ctx_advance(tctx), jres.ctx_advance(jctx)
    assert tres.ctx_round(5) == int(jres.ctx_round(jnp.int32(5))) == 5
    assert tres.ctx_advance(5) == int(jres.ctx_advance(jnp.int32(5))) == 6
    with pytest.raises(TypeError, match="FaultContext"):
        tres.ctx_advance(tst.ctx(0, 2, device="cpu").round(0))
    # every part of the schedule is on every rank in both packages; only
    # the port's skipped-lane indices are the rank's own rows
    spec = tres.ctx_specs(True)
    assert set(jres.ctx_specs(True)) == {"round", "kill_round", "delay_from",
                                         "delay_until", "drop_rounds"}
    assert (spec.dead, spec.skip, spec.drop) == (tres.REPLICATED,) * 3
    assert spec.skip_idx == tres.LOCAL and tres.ctx_specs(False) == tres.HOST


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_equals_the_jax_package(masked):
    rng = np.random.default_rng(int(masked))
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = float(jlayers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask)))
    got = tlayers.cross_entropy(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    got_f32 = float(tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask)))
    assert abs(got_f32 - want) <= 1e-6 * max(1.0, abs(want))
    assert got.dtype == torch.float32
    # an all-zero mask divides by 1, as the JAX function's does
    zero = np.zeros((3, 7), np.float32)
    assert float(tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(zero))) == float(jlayers.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(zero)))


def test_the_small_names_mean_what_the_jax_ones_do():
    q = tops.make_queue(16, torch.zeros((2,), dtype=torch.int32),
                        device="cpu")
    ops = tops.make_ops("auto")
    q, _ = ops.push(q, torch.ones((5, 2), dtype=torch.int32),
                    torch.tensor(5, dtype=torch.int32))
    assert int(tops.queue_size(q)) == 5
    # the kernels take any geometry their 32-bit extents hold
    for fn in (tops.kernel_push_available, tops.kernel_pop_available,
               tops.kernel_steal_available, tops.kernel_transfer_available):
        assert fn(16_384, 8_192) and fn(7, 3) and fn(1, 1)
        assert not fn(2 ** 31, 8)            # past a 32-bit int
        assert not fn(2 ** 29, 8)            # 2^31 bytes of int32 rows
    assert not tops.kernel_pop_available(0, 4)
    assert not tops.kernel_transfer_available(64, 2 ** 29)  # its stack
    from repro_torch.core import queue as tqueue
    from repro_torch.kernels import queue_push
    assert tqueue.queue_size is tops.queue_size
    assert tqueue.steal_counted is tops.steal_counted
    assert queue_push.ring_scatter_supported(64, 16)
    assert queue_push.DEFAULT_BLOCK == 128
    cuh = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "kernels" / "ring_copy.cuh").read_text()
    assert f"constexpr int kThreads = {queue_push.DEFAULT_BLOCK};" in cuh
    spec = {"a": torch.zeros((3,), dtype=torch.int32),
            "b": torch.zeros((), dtype=torch.bfloat16)}
    jspec = {"a": jax.ShapeDtypeStruct((3,), jnp.int32),
             "b": jax.ShapeDtypeStruct((), jnp.bfloat16)}
    assert ttelemetry.item_nbytes(spec) == jtelemetry.item_nbytes(jspec) == 14
    # the production pod: 256 devices as (data 16, model 16)
    assert tmesh.CHIPS_PER_POD == jmesh.CHIPS_PER_POD == 256
    shape, axes = tmesh.production_mesh_shape(False)
    assert (shape, axes) == ((16, 16), ("data", "model"))
    assert tmesh.production_mesh_shape(True) == ((2, 16, 16),
                                                 ("pod", "data", "model"))
    assert int(np.prod(shape)) == tmesh.CHIPS_PER_POD
    # a sharding constraint never changes a value
    x = torch.arange(6.0).reshape(2, 3)
    assert tlayers.shard(x, "data", None) is x
    assert (tlayers.axes.dp, tlayers.axes.tp, tlayers.axes.fsdp) == (
        jlayers.axes.dp, jlayers.axes.tp, jlayers.axes.fsdp)
    assert tssm.ssd_chunked is ssd_ref.ssd_chunked
    state = TrainState(params={"w": x}, opt=None)
    assert state.params["w"] is x and state._fields == ("params", "opt")
    from repro_torch import models
    from repro_torch.models import zoo
    assert models.build_model is zoo.build_model
    assert models.input_specs is zoo.input_specs


def test_cost_analysis_readers_match_the_jax_package():
    """``normalize_cost_analysis`` takes the trace's counts (a dict, a
    list of them, a ``StepTrace``) to XLA's keys, summed as the JAX
    function sums programs; ``analyze_compiled`` is ``analyze`` on them."""
    counts = [{"flops": 2.0e9, "bytes": 3.0e8}, {"flops": 1.0e9,
                                                   "bytes": 1.0e8}]
    want = jroofline.normalize_cost_analysis(
        [{"flops": 2.0e9, "bytes accessed": 3.0e8},
         {"flops": 1.0e9, "bytes accessed": 1.0e8}])
    assert troofline.normalize_cost_analysis(counts) == want
    assert troofline.normalize_cost_analysis(None) == \
        jroofline.normalize_cost_analysis(None) == {}

    class Trace:   # what a StepTrace counts
        flops, bytes = 5.0, 7.0
    assert troofline.normalize_cost_analysis(Trace()) == {
        "flops": 5.0, "bytes accessed": 7.0}
    traced = {"flops": 4.0e12, "bytes": 6.7e9,
              "records": [("all-gather", (4, 1024), (16, 1024), "float32",
                           4, "data")],
              "argument_bytes": 10, "output_bytes": 4, "temp_bytes": 30,
              "peak_bytes": 40}
    kw = dict(arch="a", shape="s", mesh_name="16x16", n_devices=256,
              model_flops=1.0e15)
    got = troofline.analyze_compiled(traced, **kw)
    assert got == troofline.analyze(
        flops=4.0e12, nbytes=6.7e9, records=traced["records"],
        memory=traced, **kw)
    assert got.compute_s == 4.0e12 / troofline.PEAK_FLOPS
    assert got.collective_bytes_per_device > 0
