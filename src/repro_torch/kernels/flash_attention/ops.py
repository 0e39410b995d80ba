"""Wrapper of K6 ``flash_attention`` at the model layout.

``mha(q, k, v, ...)`` takes q ``(B, S, H, hd)`` and k, v ``(B, T, K, hd)``
with ``H % K == 0``, as the JAX package's ``kernels.flash_attention.ops.mha``
does, and returns ``(B, S, H, hd)`` in q's dtype.  For a CPU tensor it runs
the plain version (``ref.attention_ref``).  For a CUDA tensor the dtype
picks the kernel (:func:`route`), head dims 32, 64, 112, 128 and 256, GQA
by indexing the KV head:

- bfloat16 goes to the tensor-core kernel (``flash_attention_wgmma.cu``:
  wgmma and TMA);
- float32 goes to the SIMT kernel (``flash_attention.cu``), because on
  tensor cores float32 is TF32, too coarse for the 2e-5 float32 tolerance.

There is no other route: a CUDA tensor that neither kernel takes raises.
``mha.launches`` counts every launch, ``mha.launches_tc`` those of the
tensor-core kernel.

On CUDA tensors the launch is a ``torch.autograd.Function``: its backward
recomputes the plain version from the saved q, k and v and returns that
function's gradients (``kernels/_backward.plain_grads``; GQA's KV-head
gradients are summed over the group by the plain version's index).  The
kernel fills its output through raw pointers, so without it the output
would have no ``grad_fn`` and a loss would silently lose attention's share
of every gradient.  There is no backward kernel: the JAX package has none
either (its models take the jnp path, differentiated by XLA).

:func:`mha_simt` reaches the SIMT kernel in bfloat16 too, the earlier
design of the bf16 route, for timing beside it; no model calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._backward import plain_grads
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["mha", "mha_simt", "route", "kv_tile_range", "query_blocks",
           "tile_shape", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 112, 128, 256)
_SIMT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TENSOR_CORE, SIMT = "tensor_core", "simt"


def route(dtype: torch.dtype) -> str:
    """The CUDA kernel that serves ``dtype``: bfloat16 the tensor-core
    kernel, float32 the SIMT kernel; any other dtype raises."""
    if dtype == torch.bfloat16:
        return TENSOR_CORE
    if dtype == torch.float32:
        return SIMT
    raise ValueError(f"dtype {dtype}: the kernels take float32 or bfloat16")


def tile_shape(hd: int) -> tuple[int, int]:
    """(query rows per CTA, keys per KV tile) of the tensor-core kernel at
    head dim ``hd`` (``Tile`` and ``kBQ`` in ``flash_attention_wgmma.cu``)."""
    return 64 if hd == 256 else 192, 128 if hd <= 64 else 64


def query_blocks(S: int, block_q: int) -> range:
    """First rows of the tensor-core kernel's query blocks: they end at row
    ``S``, so the first may start before row 0 (``item_of`` in
    ``flash_attention_wgmma.cu``)."""
    return range(S - block_q * -(-S // block_q), S, block_q)


def kv_tile_range(q0: int, rows: int, S: int, T: int, *, causal: bool,
                  window: Optional[int], block_k: int) -> tuple[int, int]:
    """The KV tiles ``[first, last)`` that query rows ``q0 .. q0 + rows - 1``
    (cut to ``0 .. S - 1``, right-aligned at ``T - S``) can see under the
    causal and window masks; every other tile is skipped.  ``kv_tile_range``
    in ``flash_attention_wgmma.cu`` is this function line for line."""
    q_last = min(q0 + rows, S) - 1 + (T - S)
    k_end = T
    if causal:
        k_end = min(k_end, q_last + 1)
    k_begin = 0
    if window is not None:
        k_begin = max(0, max(q0, 0) + (T - S) - window + 1)
    first = k_begin // block_k
    last = 0 if k_end <= 0 else (k_end + block_k - 1) // block_k
    return first, max(first, last)


def _check(q, k, v, window):
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dev = _lib.check_cuda(q, k, v)
    if tuple(k.shape) != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, T, K, {hd}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    return dev


def _dims(q, k):
    B, S, H, hd = q.shape
    return B, S, k.shape[1], H, k.shape[2], hd


def _flags(hd, causal, window, softcap):
    return (1.0 / hd ** 0.5, int(causal), int(window is not None),
            window or 0, int(softcap is not None), float(softcap or 0.0))


def _launch_simt(q, k, v, dev, causal, window, softcap):
    if q.dtype not in _SIMT_DTYPES:
        raise ValueError(f"dtype {q.dtype}: the SIMT kernel takes float32 "
                         f"or bfloat16")
    B, _, H, hd = q.shape
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} past the grid's 65,535")
    out = torch.empty_like(q)
    if out.numel():
        scale, *flags = _flags(hd, causal, window, softcap)
        _lib.launch("fa_flash_attention", q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), *_dims(q, k),
                    _SIMT_DTYPES[q.dtype], scale, *flags, device=dev)
    return out


def _launch(q, k, v, causal, window, softcap) -> torch.Tensor:
    """K6 on CUDA tensors, on the kernel :func:`route` picks."""
    dev = _check(q, k, v, window)
    if route(q.dtype) == SIMT:
        return _launch_simt(q, k, v, dev, causal, window, softcap)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    for t in (q, k, v, out):
        if t.data_ptr() % 16:  # TMA needs 16-byte aligned bases
            raise ValueError("the tensor-core kernel needs 16-byte aligned "
                             "q, k, v")
    _lib.launch("fa_flash_attention_wgmma", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), *_dims(q, k),
                *_flags(q.shape[3], causal, window, softcap), device=dev)
    return out


class _Attention(torch.autograd.Function):
    """Forward: K6.  Backward: the plain version's gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return _launch(q, k, v, causal, window, softcap)

    @staticmethod
    def backward(ctx, dout):
        return plain_grads(attention_ref, ctx.saved_tensors, (dout,),
                           ctx.needs_input_grad[:3], **ctx.opts) + (
                               None, None, None)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        softcap: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention; ``mha.launches`` counts the CUDA launches,
    ``mha.launches_tc`` the tensor-core kernel's among them."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    out = _Attention.apply(q, k, v, causal, window, softcap)
    if out.numel():
        mha.launches += 1
        mha.launches_tc += route(q.dtype) == TENSOR_CORE
    return out


mha.launches = 0
mha.launches_tc = 0


def mha_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             softcap: Optional[float] = None) -> torch.Tensor:
    """The SIMT kernel in float32 or bfloat16 on CUDA tensors, outside
    ``mha``'s routing and counters: the earlier bf16 design, kept so that
    its time can be taken beside the tensor-core kernel's; on CPU tensors,
    like every wrapper, the plain version."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    dev = _check(q, k, v, window)
    return _launch_simt(q, k, v, dev, causal, window, softcap)
