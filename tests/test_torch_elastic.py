"""Elastic resize of the stacked-lane runtime (``repro_torch.distributed.
elastic``) against the JAX package's under vmap: evacuation, shrink and
grow by rebuild, and the live resize of a padded runtime, each with the
same item multisets, sizes and telemetry as the JAX package's, and the
live resize leaving ``compile_count`` unchanged (vacuous until the port
captures CUDA graphs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import StealPolicy as JaxPolicy
from repro.distributed import elastic as jel
from repro.runtime import FaultPlan as JaxFaultPlan
from repro.runtime import StealRuntime as JaxRuntime
from repro_torch.core.policy import StealPolicy
from repro_torch.distributed import elastic as tel
from repro_torch.runtime import FaultPlan, StealRuntime

from _torch_fault import JSPEC, SPEC, W, items_of, queues_np
from _torch_parity import one_torch_thread  # noqa: F401

POL = dict(backend="reference", low_watermark=2, high_watermark=8,
           max_steal=64)


def _pair(plan=None, capacity=128):
    jrt = JaxRuntime(W, capacity, {"x": JSPEC}, policy=JaxPolicy(**POL),
                     fault_plan=None if plan is None else JaxFaultPlan(**plan))
    trt = StealRuntime(W, capacity, {"x": SPEC}, policy=StealPolicy(**POL),
                       fault_plan=None if plan is None else FaultPlan(**plan),
                       device="cpu")
    rng = np.random.default_rng(5)
    for w in range(W):
        n = int(rng.integers(5, 30))
        ids = np.arange(w * 100, w * 100 + n, dtype=np.int32)
        jrt.push(w, {"x": jnp.asarray(ids)}, n)
        trt.push(w, {"x": torch.from_numpy(ids)}, n)
    return jrt, trt


def _items(rt):
    buf, lo, size = queues_np(rt)
    buf = buf["x"]
    cap = buf.shape[1]
    return sorted(int(buf[i][(lo[i] + j) % cap])
                  for i in range(len(lo)) for j in range(size[i]))


def _same(jrt, trt, what):
    assert _items(jrt) == _items(trt), what
    assert np.asarray(jrt.sizes()).tolist() == trt.sizes().tolist(), what
    assert jrt.n_workers == trt.n_workers and \
        jrt.rounds_run == trt.rounds_run, what
    assert jrt.telemetry.summary() == trt.telemetry.summary(), what
    assert jrt.controller.history == trt.controller.history, what


def test_shrink_and_grow_match_reference():
    jrt, trt = _pair({})
    before = _items(trt)
    for _ in range(2):
        jrt.round()
        trt.round()
    jrt, trt = jel.shrink(jrt, [1, 5]), tel.shrink(trt, [1, 5])
    _same(jrt, trt, "shrink")
    assert trt.n_workers == W - 2 and _items(trt) == before
    jrt, trt = jel.grow(jrt, 3), tel.grow(trt, 3)
    _same(jrt, trt, "grow")
    assert trt.n_workers == W + 1 and (trt.sizes()[-3:] == 0).all()
    for _ in range(4):
        jrt.round()
        trt.round()
    _same(jrt, trt, "rounds after grow")
    assert trt.sizes()[-3:].sum() > 0 and _items(trt) == before
    assert trt.telemetry.fault_events["shrink"] == 2  # lanes dropped
    assert trt.telemetry.fault_events["grow"] == 3


def test_evacuate_matches_reference_and_refuses_to_kill_all():
    jrt, trt = _pair({})
    assert jel.evacuate(jrt, [0, 2, 4]) == tel.evacuate(trt, [0, 2, 4])
    _same(jrt, trt, "evacuate")
    assert trt.sizes()[[0, 2, 4]].sum() == 0
    assert tel.evacuate(trt, []) == 0
    with pytest.raises(ValueError, match="no live lane"):
        tel.evacuate(trt, [1, 3, 5, 6, 7])


def test_live_resize_matches_reference_and_builds_nothing():
    rts = (jel.padded_runtime(4, 128, {"x": JSPEC}, w_max=W,
                              execution="vmap", policy=JaxPolicy(**POL)),
           tel.padded_runtime(4, 128, {"x": SPEC}, w_max=W,
                              policy=StealPolicy(**POL), device="cpu"))
    jrt, trt = rts
    assert tel.n_live(trt) == 4 and (trt.sizes() == 0).all()
    jrt.push(0, {"x": jnp.arange(96, dtype=jnp.int32)}, 96)
    trt.push(0, {"x": torch.arange(96, dtype=torch.int32)}, 96)
    before = _items(trt)
    for rt in rts:
        for _ in range(3):
            rt.round()
    c0 = tel.compile_count(trt)
    for el, rt in ((jel, jrt), (tel, trt)):
        assert el.live_grow(rt, 3) == [4, 5, 6] and el.n_live(rt) == 7
        for _ in range(4):
            rt.round()
        assert rt.sizes()[[4, 5, 6]].sum() > 0
        assert el.live_shrink(rt, [0, 4]) >= 1 and el.n_live(rt) == 5
        with pytest.raises(ValueError, match="headroom"):
            el.live_grow(rt, 4)
        rt.run_fused(4)
        el.live_grow(rt, 1)
        el.live_shrink(rt, [1])
        rt.run_fused(4)
    _same(jrt, trt, "live resize")
    assert _items(trt) == before
    assert trt.telemetry.fault_log == jrt.telemetry.fault_log
    assert tel.compile_count(trt) == c0


def test_padded_runtime_and_rebuild_refusals():
    with pytest.raises(ValueError, match="n_active"):
        tel.padded_runtime(0, 16, SPEC, w_max=4, device="cpu")
    with pytest.raises(ValueError, match="padding lane"):
        tel.padded_runtime(2, 16, SPEC, w_max=4, device="cpu",
                           fault_plan=FaultPlan(kills=((3, 1),)))
    # a mesh needs a process group (tests/test_torch_distributed.py
    # builds one)
    with pytest.raises(RuntimeError, match="process group"):
        tel.padded_runtime(2, 16, SPEC, w_max=4, execution="mesh",
                           device="cpu")

    class Other(StealRuntime):
        pass

    rt = Other(4, 16, SPEC, device="cpu", fault_plan=FaultPlan(),
               policy=StealPolicy(**POL))
    with pytest.raises(TypeError, match="Other"):
        tel.grow(rt, 1)
    assert tel.shrink(rt, []) is rt and tel.grow(rt, 0) is rt
    assert items_of(rt) == []
