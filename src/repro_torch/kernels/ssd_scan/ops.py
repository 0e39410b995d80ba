"""Wrapper of K7 ``ssd_scan`` at the model layout.

``ssd(x, dt, A, Bm, Cm, D, chunk=Q)`` takes x ``(B, S, nh, hd)``, dt
``(B, S, nh)``, A and D ``(nh,)`` and Bm, Cm ``(B, S, ns)``, as the JAX
package's ``kernels.ssd_scan.ops.ssd`` does, and returns ``(y (B, S, nh,
hd) in x's dtype, final_state (B, nh, hd, ns) float32)``.  x, Bm and Cm
are float32 or bfloat16 alike; dt, A and D float32.  For a CPU tensor it
runs the plain version (``ref.ssd_chunked``).  For a CUDA tensor
:func:`route` picks the kernel from the dtype and the shape:

- bfloat16 at head dim 64, state width 64 or 128 and a chunk that is a
  multiple of 64 up to 256 (mamba2-2.7b's and zamba2-7b's scans) goes to
  the tensor-core kernel (``ssd_scan_wgmma.cu``: two launches, wgmma and
  TMA);
- every other bfloat16 shape, and float32 (on tensor cores float32 is
  TF32, too coarse for the 5e-5 / 5e-4 float32 tolerance), goes to the
  SIMT kernel (``ssd_scan.cu``: head dims 8, 16, 32, 64; state widths 8 to
  128; any chunk up to 2,048).

Both take any ``S >= 0`` and mask a ragged last chunk.  There is no other
route: a CUDA tensor that neither kernel takes raises, and a kernel that
fails to build or launch raises.  ``ssd.launches`` counts the calls that
ran a kernel, ``ssd.launches_tc`` those on the tensor-core route.
:func:`ssd_simt` reaches the SIMT kernel in bfloat16 at every shape, the
earlier design of the bf16 route, for timing beside it; no model calls it.

On CUDA tensors the launch is a ``torch.autograd.Function`` whose backward
recomputes ``ssd_chunked`` from the saved inputs and returns its gradients
for x, dt, A, Bm, Cm and D (``kernels/_backward.plain_grads``; an output
whose gradient is ``None``, as the final state's is in training, adds
nothing).  ``ssd_chunked`` rather than ``ssd_chunk_parallel``: it is the
function the CPU path runs and the tests hold against the JAX package's
autodiff, and it keeps its ``(B, Q, Q, nh)`` intermediates one chunk at a
time (at chunk 256, 80 heads of 64 and batch 2, ~0.25 GB a chunk with the
float64 differences), where ``ssd_chunk_parallel`` forms every chunk's
``(B, nc, Q, Q, nh)`` float64 differences and products at once.  There is
no backward kernel: the JAX package has none either.

On every device the call is that ``autograd.Function`` (the CPU's forward
runs ``ssd_chunked``).  On ``meta`` tensors (the dry run's trace) nothing
runs: the outputs are empty tensors of their shapes.  Every forward
call, on any device, reports the scan's operations and bytes
(``kernels.bounds.ssd_counts``) to a trace that follows it.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _lib, bounds
from repro_torch.kernels._backward import plain_grads
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

__all__ = ["ssd", "ssd_simt", "route", "HEAD_DIMS", "STATE_DIMS",
           "TENSOR_CORE", "SIMT"]

HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (8, 16, 32, 64, 128)
MAX_CHUNK = 2048
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE, SIMT = "tensor_core", "simt"
TC_HEAD_DIM, TC_STATE_DIMS, TC_TILE, TC_MAX_CHUNK = 64, (64, 128), 64, 256


def route(dtype: torch.dtype, hd: int, ns: int, chunk: int) -> str:
    """The CUDA kernel that serves a scan: the tensor-core kernel for
    bfloat16 at head dim 64, state width 64 or 128 and a chunk that is a
    multiple of 64 up to 256; the SIMT kernel for float32 and for every
    other bfloat16 shape; any other dtype raises."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype {dtype}: the kernels take float32 or "
                         f"bfloat16")
    if (dtype == torch.bfloat16 and hd == TC_HEAD_DIM
            and ns in TC_STATE_DIMS and chunk % TC_TILE == 0
            and 0 < chunk <= TC_MAX_CHUNK):
        return TENSOR_CORE
    return SIMT


def _check(x, dt, A, Bm, Cm, D, chunk):
    B, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    dev = _lib.check_cuda(x, dt, A, Bm, Cm, D)
    shapes = {"dt": (dt, (B, S, nh)), "A": (A, (nh,)), "D": (D, (nh,)),
              "Bm": (Bm, (B, S, ns)), "Cm": (Cm, (B, S, ns))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if hd not in HEAD_DIMS or ns not in STATE_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS} or state width "
                         f"{ns} not in {STATE_DIMS}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {Bm.dtype}, {Cm.dtype}: the "
                         f"kernels take float32 or bfloat16, all alike")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise ValueError("dt, A and D must be float32")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in 1..{MAX_CHUNK}")
    if B > 65535:
        raise ValueError(f"batch {B} past the grid's 65,535")
    return dev


def _launch_simt(x, dt, A, Bm, Cm, D, chunk, dev):
    B, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    y = torch.empty_like(x)
    fin = torch.empty((B, nh, hd, ns), dtype=torch.float32, device=dev)
    if B and nh:
        _lib.launch("ss_ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
                    fin.data_ptr(), B, S, nh, hd, ns, chunk,
                    _DTYPES[x.dtype], device=dev)
    return y, fin


def _launch_tc(x, dt, A, Bm, Cm, D, chunk, dev):
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):  # TMA's rule
        raise ValueError("the tensor-core kernel needs 16-byte aligned x, "
                         "Bm, Cm")
    B, S, nh, hd = x.shape
    ns = Bm.shape[-1]
    nc = -(-S // chunk)
    y = torch.empty_like(x)
    fin = torch.empty((B, nh, hd, ns), dtype=torch.float32, device=dev)
    # launch 1 writes each chunk's cumsum, masked dt and incoming state (a
    # bf16 high part and the bf16 rest); launch 2 reads them
    cs = torch.empty((B, nc, nh, chunk), dtype=torch.float64, device=dev)
    dtm = torch.empty((B, nc, nh, chunk), dtype=torch.float32, device=dev)
    s_in = torch.empty((B, nc, nh, 2, hd, ns), dtype=torch.bfloat16,
                       device=dev)
    if B and nh:
        _lib.launch("ss_ssd_scan_wgmma", x.data_ptr(), dt.data_ptr(),
                    A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                    y.data_ptr(), fin.data_ptr(), cs.data_ptr(),
                    dtm.data_ptr(), s_in.data_ptr(), B, S, nh, hd, ns, chunk,
                    device=dev)
    return y, fin


class _Scan(torch.autograd.Function):
    """Forward: K7 on the route :func:`route` picks.  Backward: the plain
    version's gradients."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        with _traced(x, Bm, chunk):
            if x.device.type == "cpu":
                return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
            if x.device.type == "meta":
                B, S, nh, hd = x.shape
                return (torch.empty_like(x),
                        torch.empty((B, nh, hd, Bm.shape[-1]),
                                    dtype=torch.float32, device=x.device))
            dev = _check(x, dt, A, Bm, Cm, D, chunk)
            tc = route(x.dtype, x.shape[3], Bm.shape[-1],
                       chunk) == TENSOR_CORE
            return (_launch_tc if tc else _launch_simt)(x, dt, A, Bm, Cm,
                                                        D, chunk, dev)

    @staticmethod
    def backward(ctx, dy, dfinal):
        return plain_grads(ssd_chunked, ctx.saved_tensors, (dy, dfinal),
                           ctx.needs_input_grad[:6], ctx.chunk) + (None,)


def _traced(x, Bm, chunk):
    """The scan's work reported to a trace, when one follows."""
    if not bounds.SINKS:
        return contextlib.nullcontext()
    B, S, nh, hd = x.shape
    return bounds.kernel("ssd_scan", *bounds.ssd_counts(
        B, S, nh, hd, Bm.shape[-1], chunk, x.element_size()))


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
        chunk: int):
    """Chunked SSD scan; ``ssd.launches`` counts the calls that ran a CUDA
    kernel, ``ssd.launches_tc`` those on the tensor-core route."""
    out = _Scan.apply(x, dt, A, Bm, Cm, D, chunk)
    if x.shape[0] and x.shape[2] and x.device.type == "cuda":
        ssd.launches += 1
        ssd.launches_tc += route(x.dtype, x.shape[3], Bm.shape[-1],
                                 chunk) == TENSOR_CORE
    return out


ssd.launches = 0
ssd.launches_tc = 0


def ssd_simt(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
             chunk: int):
    """The SIMT kernel in float32 or bfloat16 on CUDA tensors, outside
    ``ssd``'s routing and counters: the earlier bf16 design, kept so that
    its time can be taken beside the tensor-core kernel's; on CPU tensors,
    like every wrapper, the plain version."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk)
    dev = _check(x, dt, A, Bm, Cm, D, chunk)
    return _launch_simt(x, dt, A, Bm, Cm, D, chunk, dev)
