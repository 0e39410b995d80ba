"""The benchmark's yardstick on the CPU: Pisinger's generator against the
published definitions, the plain optimum against brute force, the
control's broken guarantee, and the frozen explore count against a hand
count."""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from _bench_tiny import BIG_SEED
from bench import opcount
from bench.reference import optimum as ref
from bench.reference import pisinger


def brute_force(w, p, c) -> int:
    best = 0
    for xs in itertools.product((0, 1), repeat=len(w)):
        if sum(x * wi for x, wi in zip(xs, w)) <= c:
            best = max(best, sum(x * pi for x, pi in zip(xs, p)))
    return best


@pytest.mark.parametrize("kind", pisinger.CLASSES)
def test_cycle_is_the_published_series(kind):
    n, r, H = 20, 1000, 100
    insts = pisinger.cycle(BIG_SEED, 3, kind=kind, n=n, r=r, H=H)
    assert sorted(i.h for i in insts) == list(range(1, H + 1))
    assert [i.h for i in insts] != list(range(1, H + 1))  # shuffled
    for i in insts:
        w, p = np.array(i.weights), np.array(i.profits)
        assert len(w) == len(p) == n
        assert w.min() >= 1 and w.max() <= r
        if kind == "uncorrelated":
            assert p.min() >= 1 and p.max() <= r
        else:
            assert (p == w + r // 10).all()
        assert i.capacity == (i.h * int(w.sum())) // (H + 1)


def test_uncorrelated_profits_are_drawn_apart_from_weights():
    insts = pisinger.cycle(5, 0, kind="uncorrelated", n=50, r=1000, H=100)
    w = np.array([i.weights for i in insts]).ravel()
    p = np.array([i.profits for i in insts]).ravel()
    assert abs(np.corrcoef(w, p)[0, 1]) < 0.05
    assert 450 < w.mean() < 550 and 450 < p.mean() < 550


def test_pool_and_stream():
    a = pisinger.cycle(7, 0, kind="strong", n=8, r=1000, H=10,
                       order="ascending")
    assert [i.h for i in a] == list(range(1, 11))
    pool = pisinger.pool(7, 2, kind="strong", n=8, r=1000, H=10)
    assert pool == pisinger.pool(7, 2, kind="strong", n=8, r=1000, H=10)
    assert set(a) < set(pool)  # each series its own items
    assert sorted(i.h for i in pool) == sorted(list(range(1, 11)) * 2)
    # the pool's order mixes capacities: not series after series
    assert [i.h for i in pool[:10]] != list(range(1, 11))
    s1 = list(itertools.islice(pisinger.stream(BIG_SEED, pool), 50))
    s2 = list(itertools.islice(pisinger.stream(BIG_SEED, pool), 50))
    s3 = list(itertools.islice(pisinger.stream(BIG_SEED + 1, pool), 50))
    assert s1 == s2 and s1 != s3
    for k in range(2):  # every pass is the whole pool, in its own order
        assert sorted(s1[20 * k:20 * k + 20]) == sorted(pool)
    assert s1[:20] != s1[20:40]
    with pytest.raises(ValueError):
        pisinger.cycle(1, 0, kind="inverse", n=8, r=1000, H=10)


@pytest.mark.parametrize("block", (1, 4, 5, 20))
def test_every_seed_does_the_same_blocks_in_turn(block):
    pool = pisinger.pool(7, 2, kind="uncorrelated", n=8, r=1000, H=10)
    runs = [list(itertools.islice(pisinger.stream(seed, pool, block), 40))
            for seed in (BIG_SEED, BIG_SEED + 1, 3)]
    for run in runs:  # block j of each pass holds the same instances
        for b in range(0, 40, block):
            j = b % 20
            assert sorted(run[b:b + block]) == sorted(pool[j:j + block])
    if block > 1:
        assert runs[0] != runs[1]
    else:
        assert runs[0] == runs[1] == pool * 2


@pytest.mark.parametrize("kind", pisinger.CLASSES)
def test_optimum_against_brute_force(kind):
    rng = np.random.default_rng(11)
    for n in (1, 2, 5, 9, 12):
        for inst in pisinger.cycle(int(rng.integers(2 ** 40)), 0, kind=kind,
                                   n=n, r=1000, H=6):
            assert ref.optimum(inst.weights, inst.profits, inst.capacity) \
                == brute_force(inst.weights, inst.profits, inst.capacity)
    assert ref.optimum((3, 2, 4, 6), (8, 5, 7, 6), 7) == 15
    assert ref.optimum((5,), (9,), 4) == 0


def test_control_breaks_the_guarantee_and_only_it():
    wrong = 0
    for kind in pisinger.CLASSES:
        for inst in pisinger.cycle(BIG_SEED, 0, kind=kind, n=12, r=1000,
                                   H=40):
            exact = brute_force(inst.weights, inst.profits, inst.capacity)
            got = ref.control_optimum(inst.weights, inst.profits,
                                      inst.capacity)
            assert got <= exact  # a feasible set's profit
            assert got >= exact - 12 * ref.CONTROL_PROFIT_STEP
            wrong += got != exact
    assert wrong >= 8


def test_explore_count_by_hand():
    # three subproblems at layers 0, 7 and 10 of 10, the second invalid:
    # restricted + relaxed walks 2 * (10 + 0) layers for the first, none
    # for the second (invalid) and the third (at the end)
    layer, valid = [0, 7, 10], [True, False, True]
    assert opcount.explore_layers(np.array(layer), np.array(valid), 10) == 20
    assert opcount.explore_layers(torch.tensor(layer, dtype=torch.int32),
                                  torch.tensor(valid), 10).item() == 20
    assert opcount.explore_layers(np.array([3, -1, 12]), True, 10) \
        == 2 * 7 + 2 * 10 + 0
    # width 16: 32 children a layer, 4 ops each for the arcs and two
    # sorts of 32 * log2(32) = 160 comparisons
    assert opcount.ops_per_layer(16) == 4 * 32 + 2 * 160 == 448
    assert opcount.ops_per_layer(3) == 4 * 6 + 2 * 6 * 3
    assert opcount.explore_ops(layer, valid, width=16, n_vars=10) == 20 * 448
    assert opcount.explore_bytes(3, width=16, n_vars=10) == \
        3 * 13 + 80 + 3 * 9 + 3 * 16 * 12
