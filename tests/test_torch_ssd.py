"""K7, the SSD chunked scan, in the port.

On the CPU ``ssd_scan.ops.ssd`` runs its kernel's plain version; these
tests hold it against the JAX package's ``ssd`` with the Pallas kernel in
interpret mode on the JAX package's case table, against its jnp path
(``models.ssm.ssd_chunked``) on ragged lengths, which the Pallas kernel
refuses, and against a token-by-token recurrence, at the JAX package's
tolerances (``tests/test_kernels.py``: atol 5e-5, rtol 5e-4 for the scan;
1e-4 / 1e-3 for the recurrence).  The plain version of the tensor-core
kernel's chunk-parallel order (``ref.ssd_chunk_parallel``) is held to the
same on every case, and the wrapper's routing is checked.  The CUDA
kernels themselves are held against the plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_supported
from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import cases as C
from repro_torch.kernels.ssd_scan.ops import SIMT, TENSOR_CORE, route, ssd
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_parallel,
                                              ssd_chunk_ref, ssd_chunked)
from _torch_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _both(case, seed=0):
    torch_in = C.ssd_inputs(np.random.default_rng(seed), case, CPU)
    return [jnp.asarray(t.float().numpy()) for t in torch_in], torch_in


def _assert_close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("case", C.SSD_CASES, ids=str)
def test_ssd_plain_matches_pallas_kernel(case):
    B, S, nh, hd, ns, Q, _ = case
    assert ssd_scan_supported(S, Q), "the JAX kernel must run"
    jin, tin = _both(case)
    y_k, fin_k = jax_ssd(*jin, chunk=Q, interpret=True)
    y, fin = ssd(*tin, chunk=Q)
    assert y.shape == (B, S, nh, hd) and y.dtype == tin[0].dtype
    assert fin.shape == (B, nh, hd, ns) and fin.dtype == torch.float32
    atol, rtol = C.SSD_TOL["float32"]
    _assert_close(y, y_k, atol, rtol, "y")
    _assert_close(fin, fin_k, atol, rtol, "final state")


@pytest.mark.parametrize("case", [c for c in C.SSD_EXTRA_CASES
                                  if c[-1] == "float32"], ids=str)
def test_ragged_lengths_match_the_jax_scan(case):
    """``S % Q != 0`` and ``S < Q``, which the Pallas kernel refuses: the
    JAX package pads with dt = 0 and so does the plain version."""
    *_, Q, _ = case
    jin, tin = _both(case, seed=1)
    y_r, fin_r = jax_ssd_chunked(*jin, Q)
    y, fin = ssd(*tin, chunk=Q)
    atol, rtol = C.SSD_TOL["float32"]
    _assert_close(y, y_r, atol, rtol, "y")
    _assert_close(fin, fin_r, atol, rtol, "final state")


def test_init_state_carries_a_split_scan():
    """Scanning a sequence in two parts, the second from the first's final
    state, gives the scan of the whole (what the JAX package's
    ``init_state`` is for)."""
    case = (2, 96, 3, 16, 16, 32, "float32")
    x, dt, A, Bm, Cm, D = C.ssd_inputs(np.random.default_rng(2), case, CPU)
    y, fin = ssd_chunked(x, dt, A, Bm, Cm, D, 32)
    y1, mid = ssd_chunked(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                          D, 32)
    y2, fin2 = ssd_chunked(x[:, 40:], dt[:, 40:], A, Bm[:, 40:], Cm[:, 40:],
                           D, 32, init_state=mid)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=5e-5,
                               rtol=5e-4)
    torch.testing.assert_close(fin2, fin, atol=5e-5, rtol=5e-4)


def test_chunk_matches_the_token_recurrence():
    """One chunk equals the recurrence decode runs token by token: state
    = state exp(dt a) + dt x B^T, y = state C (the port of the JAX
    package's ``test_ssd_decode_consistency``)."""
    Q, hd, ns = 16, 8, 4
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((Q, hd)) * 0.5, dtype=torch.float32)
    dt = torch.nn.functional.softplus(
        torch.tensor(rng.standard_normal(Q), dtype=torch.float32))
    a = -torch.exp(torch.tensor(rng.standard_normal() * 0.3,
                                dtype=torch.float32))
    Bm = torch.tensor(rng.standard_normal((Q, ns)) * 0.3, dtype=torch.float32)
    Cm = torch.tensor(rng.standard_normal((Q, ns)) * 0.3, dtype=torch.float32)
    y, state = ssd_chunk_ref(x, dt, a, Bm, Cm, 0.0, torch.zeros(hd, ns))
    st = torch.zeros(hd, ns)
    ys = []
    for t in range(Q):
        st = st * torch.exp(dt[t] * a) + dt[t] * torch.outer(x[t], Bm[t])
        ys.append(st @ Cm[t])
    torch.testing.assert_close(y, torch.stack(ys), atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(state, st, atol=1e-4, rtol=1e-3)
    # and the whole-sequence scan over that one chunk agrees with it
    yc, fc = ssd_chunked(x[None, :, None], dt[None, :, None], a[None],
                         Bm[None], Cm[None], torch.zeros(1), Q)
    torch.testing.assert_close(yc[0, :, 0], y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(fc[0, 0], state, atol=1e-5, rtol=1e-5)


def test_plain_scan_stays_finite_where_exp_of_the_cumsum_underflows():
    """With A = -1 and dt about 0.7 (the models' random initialisation)
    the within-chunk cumsum falls to about -180 over a chunk of 256, where
    exp(cs) is 0 in float32: exponentials of differences keep every
    value finite, and the final state equals the token recurrence."""
    B, S, nh, hd, ns, Q = 1, 256, 1, 8, 8, 256
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((B, S, nh, hd)), dtype=torch.float32)
    dt = torch.full((B, S, nh), 0.7)
    A = torch.full((nh,), -1.0)
    Bm = torch.tensor(rng.standard_normal((B, S, ns)), dtype=torch.float32)
    Cm = torch.tensor(rng.standard_normal((B, S, ns)), dtype=torch.float32)
    y, fin = ssd(x, dt, A, Bm, Cm, torch.ones(nh), chunk=Q)
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()
    st = torch.zeros(hd, ns)
    for t in range(S):
        st = st * torch.exp(dt[0, t, 0] * A[0]) + dt[0, t, 0] * torch.outer(
            x[0, t, 0], Bm[0, t])
    torch.testing.assert_close(fin[0, 0], st, atol=1e-4, rtol=1e-3)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = ssd.launches
    case = (1, 20, 2, 48, 12, 8, "float32")  # widths the kernel refuses
    y, fin = ssd(*C.ssd_inputs(np.random.default_rng(5), case, CPU), chunk=8)
    assert y.shape == (1, 20, 2, 48) and fin.shape == (1, 2, 48, 12)
    assert ssd.launches == before


@pytest.mark.parametrize("case", C.SSD_CASES + C.SSD_EXTRA_CASES, ids=str)
def test_chunk_parallel_order_matches_the_scan(case):
    """Chunk states, state passing, chunk output (the tensor-core kernel's
    order) give the chunk loop's y and final state, and the JAX package's
    (its Pallas kernel in interpret mode where it takes the shape, else its
    jnp path), at the float32 tolerance; every case in float32, since the
    point is the algorithm."""
    B, S, nh, hd, ns, Q, _ = case
    case = case[:-1] + ("float32",)
    jin, tin = _both(case, seed=6)
    y, fin = ssd_chunk_parallel(*tin, Q)
    assert y.shape == (B, S, nh, hd) and fin.shape == (B, nh, hd, ns)
    atol, rtol = C.SSD_TOL["float32"]
    y_c, fin_c = ssd_chunked(*tin, Q)
    torch.testing.assert_close(y, y_c, atol=atol, rtol=rtol)
    torch.testing.assert_close(fin, fin_c, atol=atol, rtol=rtol)
    if ssd_scan_supported(S, Q):
        y_j, fin_j = jax_ssd(*jin, chunk=Q, interpret=True)
    else:
        y_j, fin_j = jax_ssd_chunked(*jin, Q)
    _assert_close(y, y_j, atol, rtol, "y")
    _assert_close(fin, fin_j, atol, rtol, "final state")


def test_route_sends_the_serving_scans_to_the_tensor_cores():
    """bfloat16 at mamba2-2.7b's and zamba2-7b's widths (and chunks of 64
    to 256) takes the tensor-core kernel; float32 never does, nor a shape
    it does not take; other dtypes raise."""
    for case in (C.SSD_SLICE, C.SSD_HYBRID):
        _, _, _, hd, ns, Q, dtype = case
        assert route(getattr(torch, dtype), hd, ns, Q) == TENSOR_CORE
        assert route(torch.float32, hd, ns, Q) == SIMT
    for Q in (64, 128, 192):
        assert route(torch.bfloat16, 64, 128, Q) == TENSOR_CORE
    for hd, ns, Q in ((32, 128, 256), (64, 32, 256), (64, 128, 100),
                      (64, 128, 512), (16, 16, 16)):
        assert route(torch.bfloat16, hd, ns, Q) == SIMT
    for case in C.SSD_CASES + C.SSD_EXTRA_CASES:
        assert route(torch.float32, case[3], case[4], case[5]) == SIMT
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        route(torch.float16, 64, 128, 256)
