"""Helpers shared by the ``test_torch_*`` parity tests: move the same
numpy data into both packages and compare what comes back bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.ops import to_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """A module that imports this fixture runs on one intra-op thread: the
    tier-1 run puts several test processes on the host's cores, where a
    thread pool per process spends more time waiting for its threads than
    computing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(x) -> np.ndarray:
    """Unsigned-int view of a numpy / JAX / torch array (bfloat16 and float
    payloads compare by their bits)."""
    if isinstance(x, torch.Tensor):
        x = to_numpy(x)
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return a
    return a.view(f"u{a.dtype.itemsize}")


def assert_same(jax_out, torch_out, what: str = "") -> None:
    a, b = bits(jax_out), bits(torch_out)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a, b, err_msg=what)


def jax_payload(a: np.ndarray, dtype: str):
    """The JAX array of a ``repro_torch.kernels.cases.payload`` array."""
    if dtype == "bfloat16":
        return jax.lax.bitcast_convert_type(jnp.asarray(a.view(np.int16)),
                                            jnp.bfloat16)
    return jnp.asarray(a)


def tree_np(tree):
    """numpy leaves of a JAX pytree."""
    return jax.tree_util.tree_map(np.asarray, tree)
