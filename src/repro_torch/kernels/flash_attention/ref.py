"""Plain PyTorch version of K6 ``flash_attention``.

Softmax attention at the model layout with float32 logits, softmax and
products, optional causal mask, sliding window and gemma2 logit softcap,
and queries right-aligned at ``T - S`` — the function the CUDA kernel
(``flash_attention.cu``) computes.  GQA takes KV head ``h // (H // K)``.

One difference from the JAX package's ``attention_ref``: a query row that
sees no key at all (causal with ``S > T``, or a window that hides every
key) comes out as 0, as the TPU kernel and the CUDA kernel give it
(running max from -1e30, masked probabilities zeroed, denominator clamped
at 1e-30); ``attention_ref`` in the JAX package gives NaN there.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "visible"]


def visible(S: int, T: int, *, causal: bool, window: Optional[int],
            device=None) -> torch.Tensor:
    """``(S, T)`` bool: which keys each right-aligned query row sees."""
    q_pos = torch.arange(S, device=device)[:, None] + (T - S)
    k_pos = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, K, hd) with H % K == 0.

    Returns (B, S, H, hd) in q.dtype.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    f32 = torch.float32
    kh = torch.arange(H, device=q.device) // (H // K)
    ke = k.to(f32)[:, :, kh]
    ve = v.to(f32)[:, :, kh]
    logits = torch.einsum("bshd,bthd->bhst", q.to(f32), ke) * (1.0 / hd ** 0.5)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    ok = visible(S, T, causal=causal, window=window, device=q.device)
    logits = logits.masked_fill(~ok, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * ok
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhst,bthd->bshd", p / denom, ve)
    return out.to(q.dtype)
