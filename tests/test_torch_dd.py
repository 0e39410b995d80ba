"""The port's DD solver (``repro_torch.core.dd``) against the JAX package's:
layer expansion, the three reductions (with tied states and values),
the bounds, ``explore_batch`` on random pools, and the whole slice —
``parallel_solve(device="cpu")`` — whose optimum, supersteps, explored
counts and telemetry must be equal.  The resolved routing is the one
difference allowed: ``"pallas"`` there, ``"cuda"`` here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dd import bnb as jbnb
from repro.core.dd import diagram as jdd
from repro.core.dd.knapsack import random_instance as jax_random_instance
from repro.core.dd.parallel import parallel_solve as jax_parallel_solve
from repro_torch.core.dd import bnb as tbnb
from repro_torch.core.dd import diagram as tdd
from repro_torch.core.dd.knapsack import dp_solve, random_instance
from repro_torch.core.dd.parallel import parallel_solve

from _torch_parity import assert_same, one_torch_thread  # noqa: F401

WIDTH = 8


def _pool(rng, b, n, hi=12):
    """Pools with many tied states and values and some dead slots."""
    s = rng.integers(-1, hi, (b, n)).astype(np.int32)
    v = rng.integers(0, 6, (b, n)).astype(np.int32)
    v = np.where(s >= 0, v, jdd.NEG).astype(np.int32)
    return s, v


def _jpool(s, v):
    return jdd.Pool(jnp.asarray(s), jnp.asarray(v))


def _tpool(s, v):
    return tdd.Pool(torch.as_tensor(s), torch.as_tensor(v))


def _assert_pool(jp, tp, what):
    assert_same(np.asarray(jp.states), tp.states, f"{what} states")
    assert_same(np.asarray(jp.values), tp.values, f"{what} values")


@pytest.mark.parametrize("seed", range(3))
def test_layer_and_reductions_match_reference(seed):
    rng = np.random.default_rng(seed)
    s, v = _pool(rng, 64, WIDTH)
    w, p = int(rng.integers(0, 6)), int(rng.integers(0, 9))
    _assert_pool(jax.vmap(lambda a, b: jdd.expand_layer(jdd.Pool(a, b), w,
                                                        p))(*_jpool(s, v)),
                 tdd.expand_layer(_tpool(s, v), w, p), "expand")
    s2, v2 = _pool(rng, 64, 2 * WIDTH)
    jc, tc = _jpool(s2, v2), _tpool(s2, v2)
    jex, jover = jax.vmap(lambda a, b: jdd.reduce_exact(jdd.Pool(a, b),
                                                        WIDTH))(*jc)
    tex, tover = tdd.reduce_exact(tc, WIDTH)
    _assert_pool(jex, tex, "exact")
    assert_same(np.asarray(jover), tover, "overflow")
    _assert_pool(jax.vmap(lambda a, b: jdd.reduce_restricted(
        jdd.Pool(a, b), WIDTH))(*jc), tdd.reduce_restricted(tc, WIDTH),
        "restricted")
    _assert_pool(jax.vmap(lambda a, b: jdd.reduce_relaxed(
        jdd.Pool(a, b), WIDTH))(*jc), tdd.reduce_relaxed(tc, WIDTH),
        "relaxed")


def _subproblems(rng, inst, b):
    layer = rng.integers(0, inst.n, b).astype(np.int32)
    state = rng.integers(0, inst.capacity + 1, b).astype(np.int32)
    value = rng.integers(0, 200, b).astype(np.int32)
    return layer, state, value


@pytest.mark.parametrize("seed", range(2))
def test_bounds_and_explore_batch_match_reference(seed):
    rng = np.random.default_rng(seed)
    inst = random_instance(10, seed=seed)
    jw, jp = jnp.asarray(inst.weights, jnp.int32), jnp.asarray(
        inst.profits, jnp.int32)
    tw, tp = torch.tensor(inst.weights, dtype=torch.int32), torch.tensor(
        inst.profits, dtype=torch.int32)
    layer, state, value = _subproblems(rng, inst, 24)
    jprimal, jdual = jax.vmap(lambda s, v, l: jdd.build_bounds(
        s, v, l, jw, jp, width=WIDTH, n_vars=inst.n))(
        jnp.asarray(state), jnp.asarray(value), jnp.asarray(layer))
    tprimal, tdual = tdd.build_bounds(
        torch.as_tensor(state), torch.as_tensor(value),
        torch.as_tensor(layer), tw, tp, width=WIDTH, n_vars=inst.n)
    assert_same(np.asarray(jprimal), tprimal, "primal")
    assert_same(np.asarray(jdual), tdual, "dual")

    valid = rng.random(24) < 0.7
    jout = jbnb.explore_batch(
        jbnb.Subproblem(jnp.asarray(layer), jnp.asarray(state),
                        jnp.asarray(value)), jnp.asarray(valid), jw, jp,
        width=WIDTH, n_vars=inst.n)
    tout = tbnb.explore_batch(
        tbnb.Subproblem(torch.as_tensor(layer), torch.as_tensor(state),
                        torch.as_tensor(value)), torch.as_tensor(valid),
        tw, tp, width=WIDTH, n_vars=inst.n)
    for k in ("primal", "dual", "exact"):
        assert_same(np.asarray(jout[k]), tout[k], k)
    for f in ("layer", "state", "value"):
        assert_same(np.asarray(getattr(jout["children"], f)),
                    getattr(tout["children"], f), f"children {f}")


SOLVER_CASES = [
    # (n_items, seed, n_workers, fused_rounds)
    (12, 0, 4, 8), (12, 1, 4, 8), (12, 2, 4, 8),
    (16, 1, 8, 8), (16, 1, 8, 1),
    (24, 2, 8, 8),   # 138 supersteps, 83 steals
]


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_parallel_solve_matches_reference(case):
    n, seed, workers, fused = case
    kw = dict(n_workers=workers, explore_width=WIDTH, batch=4,
              fused_rounds=fused)
    jopt, jst = jax_parallel_solve(jax_random_instance(n, seed=seed), **kw)
    inst = random_instance(n, seed=seed)
    topt, tst = parallel_solve(inst, device="cpu", **kw)
    assert topt == jopt == dp_solve(inst)
    for key in ("supersteps", "explored", "transferred",
                "per_worker_explored", "execution"):
        assert tst[key] == jst[key], key
    assert tst["telemetry"] == jst["telemetry"]
    assert (jst["backend"], tst["backend"]) == ("pallas", "cuda")


def test_parallel_solve_refuses_no_row():
    """The largest of the cases above: no child refused by a full ring,
    and each lane's peak after a push within the ring."""
    n, seed, workers, fused = SOLVER_CASES[-1]
    _, st = parallel_solve(random_instance(n, seed=seed), device="cpu",
                           n_workers=workers, explore_width=WIDTH, batch=4,
                           fused_rounds=fused)
    assert st["ring_refused_rows"] == 0
    assert len(st["per_worker_ring_peak"]) == workers
    assert 0 < max(st["per_worker_ring_peak"]) <= st["ring_peak_rows"]
    assert st["ring_peak_rows"] <= 4096


def test_a_full_ring_refusing_rows_is_loud():
    """n 18 on rings of 8 rows: children are refused, so the optimum is
    not proven; the solve warns, naming the capacity and the count, and
    raises where the caller makes the warning an error."""
    import warnings

    from repro_torch.core.dd.parallel import RingOverflowWarning

    inst = random_instance(18, seed=0)
    with pytest.warns(RingOverflowWarning,
                      match=r"rings of 8 rows refused \d+ subproblems"):
        _, st = parallel_solve(inst, device="cpu", capacity=8)
    assert st["ring_refused_rows"] > 0 and st["ring_peak_rows"] == 8
    with warnings.catch_warnings():
        warnings.simplefilter("error", RingOverflowWarning)
        with pytest.raises(RingOverflowWarning, match="rings of 8 rows"):
            parallel_solve(inst, device="cpu", capacity=8)


@pytest.mark.parametrize("capacity", [8, 4096])
def test_ring_counters_equal_in_fused_and_single_rounds(capacity):
    """A fused block's gated rounds past the drain add nothing to the
    ring counters: blocks of 8 rounds count what single rounds count."""
    from repro_torch.core.dd.diagram import NEG
    from repro_torch.core.dd.parallel import _item_spec, _make_worker_body
    from repro_torch.core.policy import StealPolicy
    from repro_torch.distributed import launch_runtime

    inst = random_instance(18, seed=0)

    def counters(fused):
        rt = launch_runtime(4, capacity, _item_spec(), execution="vmap",
                            device="cpu",
                            policy=StealPolicy(proportion=0.5,
                                               high_watermark=4,
                                               max_steal=min(capacity, 64)))
        rt.push(0, {"layer": torch.zeros((1,), dtype=torch.int32),
                    "state": torch.full((1,), inst.capacity,
                                        dtype=torch.int32),
                    "value": torch.zeros((1,), dtype=torch.int32)}, 1)
        w = torch.tensor(inst.weights, dtype=torch.int32)
        p = torch.tensor(inst.profits, dtype=torch.int32)
        body = _make_worker_body(w, p, rt.ops, rt.lanes, explore_width=WIDTH,
                                 batch=4, n_vars=inst.n)
        zero = torch.zeros((4,), dtype=torch.int32)
        carry = rt.run(body, {"incumbent": torch.full((4,), NEG,
                                                      dtype=torch.int32),
                              "explored": zero, "ring_refused": zero,
                              "ring_peak": zero}, fused=fused)
        return rt.rounds_run, {k: carry[k].tolist() for k in
                               ("explored", "ring_refused", "ring_peak")}

    fused, single = counters(8), counters(1)
    assert fused == single
    assert (sum(fused[1]["ring_refused"]) > 0) == (capacity == 8)
    assert max(fused[1]["ring_peak"]) <= capacity


def test_knapsack_copy_matches_reference():
    from repro.core.dd.knapsack import dp_solve as jax_dp_solve

    for seed in range(3):
        mine = random_instance(15, seed=seed)
        theirs = jax_random_instance(15, seed=seed)
        assert (mine.weights, mine.profits, mine.capacity) == (
            theirs.weights, theirs.profits, theirs.capacity)
        assert dp_solve(mine) == jax_dp_solve(theirs)


@pytest.mark.parametrize("seed", range(4))
def test_sequential_solve_matches_reference(seed):
    """The sequential oracle: the JAX package's ``bnb.solve`` at its test
    size (12 items, width 8) and at its defaults on 16 items, optimum and
    every stats counter equal, and the optimum equal to ``dp_solve``."""
    for n, kw in ((12, dict(width=8)), (16, {})):
        jopt, jst = jbnb.solve(jax_random_instance(n, seed=seed), **kw)
        inst = random_instance(n, seed=seed)
        topt, tst = tbnb.solve(inst, device="cpu", **kw)
        assert topt == jopt == dp_solve(inst), (n, seed)
        assert tst == jst, (n, seed)
