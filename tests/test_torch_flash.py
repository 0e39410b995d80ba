"""K6 flash attention in the port.

On the CPU ``mha`` runs its kernel's plain version; these tests hold it
against the JAX package's ``mha`` with the Pallas kernel in interpret mode,
on the same seeded inputs, at the JAX package's tolerances (2e-5 for
float32, 2e-2 for bfloat16, ``tests/test_kernels.py``).  Rows that see no
key (causal with ``S > T``) must be 0, as the TPU kernel gives them.  The
CUDA kernel itself is held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on a GPU.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_supported
from repro.kernels.flash_attention.ops import mha as jax_mha
from repro_torch.kernels import cases as C
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.flash_attention.ref import attention_ref, visible

from _torch_parity import jax_payload

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


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > c[2]], ids=str)
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
