"""K5's redesign, the fused DD explore, and K3 on the ring-copy tree, on the
CPU.

The card holds the fused kernel (``kernels/dd_expand/explore.cu``) to its
plain version, ``bnb.explore_batch_plain``, bit for bit; here that plain
version is held to the JAX package's ``explore_batch`` on every
``cases.EXPLORE_CASES`` entry, so the kernel's yardstick is the reference.
K3's tree wrapper, ``pop_slice``, is held to the JAX wrapper on a
mixed-dtype payload tree.  On CPU tensors neither launches anything.
Inputs are drawn with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dd import bnb as jbnb
from repro.kernels.queue_push.ops import pop_slice as jax_pop_slice
from repro_torch.core.dd import bnb
from repro_torch.kernels import cases as C
from repro_torch.kernels.dd_expand.ops import expand_pool, explore_fused
from repro_torch.kernels.queue_push.ops import pop_slice, ring_slice

from _torch_parity import assert_same, jax_payload
from _torch_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _explore_both(case, seed=0):
    """The case's inputs through the JAX package's ``explore_batch`` and
    through ``bnb.explore_batch_plain`` on CPU tensors."""
    _, _, width, n_vars = case[:4]
    x = C.explore_inputs(np.random.default_rng(seed), case)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = jbnb.explore_batch(
        jbnb.Subproblem(j["layer"], j["state"], j["value"]), j["valid"],
        j["weights"], j["profits"], width=width, n_vars=n_vars)
    got = bnb.explore_batch_plain(
        bnb.Subproblem(t["layer"], t["state"], t["value"]), t["valid"],
        t["weights"], t["profits"], width=width, n_vars=n_vars)
    return x, want, got, t


@pytest.mark.parametrize("case", C.EXPLORE_CASES, ids=lambda c: c[0])
def test_plain_explore_matches_reference(case):
    x, want, got, _ = _explore_both(case)
    for k in ("primal", "dual", "exact"):
        assert_same(np.asarray(want[k]), got[k], f"{case[0]} {k}")
    for f in ("layer", "state", "value"):
        assert_same(np.asarray(getattr(want["children"], f)),
                    getattr(got["children"], f), f"{case[0]} children {f}")
    # each case reaches what it is there for
    exact, valid = got["exact"].numpy(), x["valid"]
    if case[0] == "exact":
        assert exact[valid].all()
    elif case[0] in ("overflow", "solver"):
        assert not exact[valid].all() and valid.any()
        if case[0] == "overflow":
            assert not exact.any()
    assert (~valid).any() == (case[-1] > 0)


def test_cpu_tensors_launch_nothing():
    """On CPU tensors ``explore_batch`` is its plain version and ``pop_slice``
    the plain K3: no counter moves."""
    case = C.EXPLORE_CASES[0]
    _, _, width, n_vars = case[:4]
    counters = (explore_fused, expand_pool, pop_slice)
    before = [fn.launches for fn in counters]
    _, _, plain, t = _explore_both(case)
    out = bnb.explore_batch(
        bnb.Subproblem(t["layer"], t["state"], t["value"]), t["valid"],
        t["weights"], t["profits"], width=width, n_vars=n_vars)
    for k in ("primal", "dual", "exact"):
        assert torch.equal(out[k], plain[k])
    for a, b in zip(out["children"], plain["children"]):
        assert torch.equal(a, b)
    cap, m, lo, size, n = C.SLICE_TREE_CASE
    rings = {k: torch.from_numpy(C.payload(np.random.default_rng(1),
                                           (len(lo), cap) + shape, "int32"))
             for k, (shape, _) in C.TREE_LEAVES.items()}
    cursors = [torch.tensor(c, dtype=torch.int32) for c in (lo, size, n)]
    pop_slice(rings, *cursors, max_n=m)
    ring_slice(rings["id"], *cursors, m)
    assert [fn.launches for fn in counters] == before


def test_explore_kernel_refuses_cpu_tensors():
    """The fused kernel's wrapper never takes a plain route itself: CPU
    tensors go through ``bnb.explore_batch``'s plain version instead."""
    z = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        explore_fused(z, z, z, z.bool(), z, z, width=4, n_vars=4)


def test_slice_tree_matches_pallas():
    """The mixed-dtype payload tree (int32 ``(L, cap)``, bfloat16 ``(L,
    cap, 3)``, float32 ``(L, cap, 5)``) through one call of K3's tree
    wrapper, against the JAX wrapper on the same tree, lane by lane."""
    cap, m, lo, size, n = C.SLICE_TREE_CASE
    dtypes = {k: dt for k, (_, dt) in C.TREE_LEAVES.items()}
    arrays = C.tree_payload(np.random.default_rng(9), (len(lo), cap))
    jr = {k: jax_payload(a, dtypes[k]) for k, a in arrays.items()}
    tr = {k: C.to_tensor(a, dtypes[k], CPU) for k, a in arrays.items()}
    got = pop_slice(tr, *(torch.tensor(c, dtype=torch.int32)
                          for c in (lo, size, n)), max_n=m)
    for l in range(len(lo)):
        want = jax_pop_slice({k: v[l] for k, v in jr.items()},
                             jnp.int32(lo[l]), jnp.int32(size[l]),
                             jnp.int32(n[l]), max_n=m, interpret=True)
        for k in dtypes:
            assert_same(want[k], got[k][l], f"ring_slice {k} lane {l}")
