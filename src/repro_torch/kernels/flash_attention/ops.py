"""Wrapper of K6 ``flash_attention`` at the model layout.

``mha(q, k, v, ...)`` takes q ``(B, S, H, hd)`` and k, v ``(B, T, K, hd)``
with ``H % K == 0``, as the JAX package's ``kernels.flash_attention.ops.mha``
does, and returns ``(B, S, H, hd)`` in q's dtype.  For a CUDA tensor it
launches the CUDA kernel (``flash_attention.cu``: float32 or bfloat16,
head dims 32, 64, 128 and 256, GQA by indexing the KV head); for a CPU
tensor it runs the plain version (``ref.attention_ref``).  There is no
other route: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["mha", "HEAD_DIMS"]

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        softcap: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention; ``mha.launches`` counts the CUDA launches."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"kernel takes float32 or bfloat16, all alike")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} past the grid's 65,535")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _lib.launch("fa_flash_attention", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), B, S, T, H, K, hd,
                _DTYPES[q.dtype], 1.0 / hd ** 0.5, int(causal),
                int(window is not None), window or 0,
                int(softcap is not None), float(softcap or 0.0), device=dev)
    mha.launches += 1
    return out


mha.launches = 0
