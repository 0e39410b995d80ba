"""K6 flash attention in the port.

On the CPU ``mha`` runs its kernel's plain version; these tests hold it
against the JAX package's ``mha`` with the Pallas kernel in interpret mode,
on the same seeded inputs, at the JAX package's tolerances (2e-5 for
float32, 2e-2 for bfloat16, ``tests/test_kernels.py``).  Rows that see no
key (causal with ``S > T``) must be 0, as the TPU kernel gives them.  The
CUDA kernels themselves are held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on a GPU; what of them
is plain Python is tested here: which kernel a dtype goes to, and the rule
(``ops.kv_tile_range``, mirrored line for line in
``flash_attention_wgmma.cu``) that picks the KV tiles a query block visits.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.flash_attention.kernel import flash_attention_supported
from repro.kernels.flash_attention.ops import mha as jax_mha
from repro_torch.kernels import cases as C
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, SIMT,
                                                     TENSOR_CORE,
                                                     kv_tile_range, mha,
                                                     mha_simt, query_blocks,
                                                     route, tile_shape)
from repro_torch.kernels.flash_attention.ref import attention_ref, visible

from _torch_parity import jax_payload, one_torch_thread  # noqa: F401

CASES = C.FLASH_CASES + C.FLASH_EXTRA_CASES


def _inputs(case, seed=0):
    B, S, T, H, K, hd, _, _, _, dtype = case
    rng = np.random.default_rng(seed)
    arrays = [C.payload(rng, shape, dtype)
              for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]
    return ([jax_payload(a, dtype) for a in arrays],
            [C.to_tensor(a, dtype, "cpu") for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_mha_plain_matches_pallas_kernel(case):
    B, S, T, H, K, hd, causal, window, cap, dtype = case
    assert flash_attention_supported(S, T), "the JAX kernel must run"
    (jq, jk, jv), (q, k, v) = _inputs(case)
    want = jax_mha(jq, jk, jv, causal=causal, window=window, softcap=cap,
                   interpret=True)
    got = mha(q, k, v, causal=causal, window=window, softcap=cap)
    assert got.dtype == q.dtype and got.shape == (B, S, H, hd)
    tol = C.FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > c[2] and c[6]],
                         ids=str)
def test_rows_that_see_no_key_are_zero_like_the_tpu_kernel(case):
    B, S, T, H, K, hd, causal, window, cap, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(case, seed=1)
    blind = ~visible(S, T, causal=causal, window=window).any(dim=1)
    assert blind.any()
    got = attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    want = _f32(jax_mha(jq, jk, jv, causal=causal, window=window,
                        softcap=cap, interpret=True))
    assert (got[:, blind] == 0).all()
    assert (want[:, blind.numpy()] == 0).all()
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("case", C.FLASH_RAGGED_CASES, ids=str)
def test_mha_plain_matches_the_jax_reference_on_ragged_tails(case):
    """Unmasked attention over 1,000 keys (not a whole number of 128-key
    tiles): the JAX kernel refuses it, so its ``mha`` takes the package's
    reference, which the plain version must match."""
    B, S, T, H, K, hd, causal, window, cap, dtype = case
    assert not flash_attention_supported(S, T)
    (jq, jk, jv), (q, k, v) = _inputs(case)
    want = jax_mha(jq, jk, jv, causal=causal, window=window, softcap=cap,
                   interpret=True)
    got = mha(q, k, v, causal=causal, window=window, softcap=cap)
    tol = C.FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_plain_version_indexes_kv_heads_like_repeating_them():
    """GQA: query head h reads KV head h // (H // K), which is what the
    JAX package's ``jnp.repeat`` of K and V along the head axis gives."""
    case = (2, 64, 64, 8, 2, 32, True, None, None, "float32")
    _, (q, k, v) = _inputs(case)
    grouped = attention_ref(q, k, v)
    repeated = attention_ref(q, k.repeat_interleave(4, dim=2),
                             v.repeat_interleave(4, dim=2))
    assert torch.equal(grouped, repeated)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = mha.launches
    q = torch.zeros(1, 4, 2, 48)  # a head dim the CUDA kernel does not take
    out = mha(q, q[:, :, :1], q[:, :, :1])
    assert out.shape == q.shape and mha.launches == before


def test_cpu_tensors_take_the_plain_version_in_the_simt_wrapper_too():
    case = (1, 64, 64, 4, 2, 32, True, None, None, "bfloat16")
    _, (q, k, v) = _inputs(case)
    before = (mha.launches, mha.launches_tc)
    assert torch.equal(mha_simt(q, k, v), attention_ref(q, k, v))
    assert (mha.launches, mha.launches_tc) == before


@pytest.mark.parametrize("dtype, kernel", [(torch.bfloat16, TENSOR_CORE),
                                           (torch.float32, SIMT)], ids=str)
def test_dtype_routing_sends_bf16_to_tensor_cores_and_float32_to_simt(
        dtype, kernel):
    assert route(dtype) == kernel


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32],
                         ids=str)
def test_dtype_routing_refuses_what_neither_kernel_takes(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        route(dtype)


@settings(max_examples=300, deadline=None)
@given(S=st.integers(1, 300), T=st.integers(1, 300), causal=st.booleans(),
       window=st.one_of(st.just(None), st.integers(1, 200)),
       blocks=st.sampled_from([tile_shape(hd) for hd in HEAD_DIMS]
                              + [(16, 8), (8, 16), (32, 32)]))
def test_kv_tile_range_visits_exactly_the_tiles_with_visible_keys(
        S, T, causal, window, blocks):
    """For every query block of the tensor-core kernel's tilings (and of
    small ones, whose edges the masks cross more often): no skipped KV tile
    holds a key that a row of the block sees, and the visited range is the
    smallest tile-aligned one that holds them all (empty when the block
    sees no key)."""
    block_q, block_k = blocks
    ok = visible(S, T, causal=causal, window=window)
    starts = list(query_blocks(S, block_q))
    assert starts[0] > -block_q and starts[-1] + block_q == S
    for q0 in starts:
        first, last = kv_tile_range(q0, block_q, S, T, causal=causal,
                                    window=window, block_k=block_k)
        keys = ok[max(q0, 0):q0 + block_q].any(dim=0).nonzero().flatten()
        if keys.numel() == 0:
            assert first == last
        else:
            assert (first, last) == (int(keys[0]) // block_k,
                                     int(keys[-1]) // block_k + 1)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_keys_outside_the_visited_tiles_do_not_change_the_output(case):
    """The case table under the tensor-core kernel's tiling: K and V rows
    outside the KV tiles a query block visits, overwritten with 1e4, leave
    the block's output exactly as it was."""
    B, S, T, H, K, hd, causal, window, cap, dtype = case
    _, (q, k, v) = _inputs(case)
    kw = dict(causal=causal, window=window, softcap=cap)
    block_q, block_k = tile_shape(hd)
    want = attention_ref(q, k, v, **kw)
    for q0 in query_blocks(S, block_q):
        first, last = kv_tile_range(q0, block_q, S, T, causal=causal,
                                    window=window, block_k=block_k)
        outside = torch.ones(T, dtype=torch.bool)
        outside[first * block_k:last * block_k] = False
        k2, v2 = k.clone(), v.clone()
        k2[:, outside] = 1e4
        v2[:, outside] = 1e4
        rows = slice(max(q0, 0), q0 + block_q)
        assert torch.equal(attention_ref(q, k2, v2, **kw)[:, rows],
                           want[:, rows])
