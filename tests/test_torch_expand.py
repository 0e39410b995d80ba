"""K5, DD layer expansion, in the port.

On the CPU the wrappers run K5's plain version; these tests hold it
against the JAX package's ``expand_layer_bulk`` with the Pallas kernel in
interpret mode on the JAX package's case table, and the batched layout the
solver uses against ``repro.core.dd.diagram.expand_layer`` under
``jax.vmap`` — bit for bit, as integer arithmetic must.  The CUDA kernel
itself is held against the plain version by ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` on a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dd import diagram as jdd
from repro.kernels.dd_expand.ops import expand_layer_bulk as jax_bulk
from repro_torch.core.dd import diagram as tdd
from repro_torch.kernels import cases as C
from repro_torch.kernels.dd_expand.ops import expand_layer_bulk, expand_pool

from _torch_parity import assert_same, one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.mark.parametrize("case", C.EXPAND_CASES, ids=str)
def test_expand_plain_matches_pallas_kernel(case):
    n, (w, p) = case
    s, v = C.expand_inputs(np.random.default_rng(n + w), (n,), CPU)
    want_s, want_v = jax_bulk(jnp.asarray(s.numpy()), jnp.asarray(v.numpy()),
                              w, p, interpret=True)
    got_s, got_v = expand_layer_bulk(s, v, w, p)
    assert got_s.shape == (2 * n,) and got_s.dtype == torch.int32
    assert_same(want_s, got_s, "states")
    assert_same(want_v, got_v, "values")


@pytest.mark.parametrize("wp", [(3, 8), (50, 1), (0, 0), (120, 7)])
def test_batched_pools_match_vmapped_expand_layer(wp):
    """``(B, W)`` pools give ``(B, 2W)``, each row ``[0-arcs | 1-arcs]``
    (flattening the pool first would interleave the rows wrongly), with w
    and p as 0-d int32 tensors, as the solver passes them."""
    w, p = wp
    s, v = C.expand_inputs(np.random.default_rng(w), C.EXPAND_SOLVER, CPU)
    want = jax.vmap(lambda a, b: jdd.expand_layer(
        jdd.Pool(a, b), jnp.int32(w), jnp.int32(p)))(
            jnp.asarray(s.numpy()), jnp.asarray(v.numpy()))
    wt, pt = (torch.tensor(x, dtype=torch.int32) for x in (w, p))
    got = tdd.expand_layer(tdd.Pool(s, v), wt, pt)
    assert tuple(got.states.shape) == (C.EXPAND_SOLVER[0],
                                       2 * C.EXPAND_SOLVER[1])
    assert_same(want.states, got.states, "states")
    assert_same(want.values, got.values, "values")
    # the same as the (N,) reach row by row
    for r in (0, 7):
        rs, rv = expand_layer_bulk(s[r], v[r], w, p)
        assert torch.equal(rs, got.states[r]) and torch.equal(rv, got.values[r])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = expand_pool.launches
    s = torch.tensor([5, -1, 2], dtype=torch.int64)  # a dtype K5 refuses
    out_s, out_v = expand_pool(s, s, 3, 4)
    assert out_s.tolist() == [5, -1, 2, 2, -1, -1]
    assert out_v.tolist() == [5, -2 ** 30, 2, 9, -2 ** 30, -2 ** 30]
    assert expand_pool.launches == before
    with pytest.raises(ValueError, match="N,"):
        expand_layer_bulk(s[None], s[None], 3, 4)
