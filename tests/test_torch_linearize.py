"""The port's model checker (``repro_torch.analysis.linearize``) against the
JAX package's (``repro.analysis.linearize``): the sweep is clean on every
port backend with the pinned history counts, which equal JAX
``check_backend``'s on the same scripts; every seeded reconcile mutation
is caught; the split steal really interposes owner steps; the sequential
spec counts the steal in float32; the CLI exits 0."""

import pytest

from repro.analysis import linearize as jlin
from repro_torch.analysis import linearize as lin

from _torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"
# port backend -> the JAX package's backend of the same routing
JAX_NAME = {"reference": "reference", "cuda": "pallas", "auto": "auto",
            "relaxed": "relaxed"}


@pytest.mark.parametrize("backend", lin.ALL_BACKENDS)
def test_quick_sweep_is_clean_with_the_pinned_counts(backend):
    n, bad = lin.check_backend(backend, capacity=4, max_steal=2, device=CPU)
    assert bad == [], bad[:3]
    assert n == lin.expected_histories(backend)
    j_n, j_bad = jlin.check_backend(JAX_NAME[backend], capacity=4,
                                    max_steal=2)
    assert j_bad == [] and j_n == n


@pytest.mark.parametrize("backend", ["reference", "relaxed"])
def test_larger_ring_counts_equal_the_jax_package(backend):
    n, bad = lin.check_backend(backend, capacity=8, max_steal=4, device=CPU)
    assert bad == [], bad[:3]
    assert n == lin.expected_histories(backend)
    assert n == jlin.check_backend(backend, capacity=8, max_steal=4)[0]


def test_full_sweep_is_clean_on_every_backend():
    counts = {}
    total, bad = lin.check_all(device=CPU, counts=counts)
    assert bad == [], bad[:3]
    assert counts == {(b, cap, ms): lin.expected_histories(b)
                      for cap, ms in ((4, 2), (8, 4))
                      for b in lin.ALL_BACKENDS}
    assert total == 2 * (3 * lin.FENCED_HISTORIES + lin.SPLIT_HISTORIES)


@pytest.mark.parametrize("name", sorted(lin.MUTATIONS))
def test_seeded_mutations_are_caught(name):
    """Each seeded bug in the reconcile must produce a violating history,
    as it does in the JAX package's checker."""
    _, bad = lin.check_backend("relaxed", capacity=4, max_steal=2,
                               reconcile_fn=lin.MUTATIONS[name], device=CPU)
    assert bad, f"mutation '{name}' survived the sweep undetected"
    _, j_bad = jlin.check_backend("relaxed", capacity=4, max_steal=2,
                                  reconcile_fn=jlin.MUTATIONS[name])
    assert len(bad) == len(j_bad)
    # the first violating history is the same one in both packages
    assert bad[0].split(" -> ")[0] == j_bad[0].split(" -> ")[0]


def test_run_mutations_catches_every_entry():
    caught = lin.run_mutations(device=CPU)
    assert set(caught) == set(jlin.MUTATIONS)
    assert all(n > 0 for n in caught.values()), caught


def test_split_enumerates_interposed_owners():
    steps = lin.expand_stealer([("steal_exact", 2)], split=True)
    assert [kind for kind, _ in steps] == ["read", "reconcile"]
    merged = list(lin.interleavings([("pop",)], steps))
    assert [("read", ("steal_exact", 2)), ("owner", ("pop",)),
            ("reconcile", ("steal_exact", 2))] in merged
    assert merged == list(jlin.interleavings([("pop",)], steps))


def test_spec_steal_is_float32():
    """ROADMAP C4's program: 10 items, steal(0.9) takes 9 in float32."""
    for spec in (lin.SeqSpec(16, range(1, 11)), jlin.SeqSpec(16,
                                                             range(1, 11))):
        assert spec.steal(0.9, 0, 16) == list(range(1, 10))


def test_cli_quick_and_mutate_exit_zero(capsys):
    assert lin.main(["--quick", "--device", "cpu"]) == 0
    assert "no violations" in capsys.readouterr().out
    assert lin.main(["--mutate", "--device", "cpu"]) == 0
    assert "seeded mutations caught" in capsys.readouterr().out
