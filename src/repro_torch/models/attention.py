"""GQA attention with RoPE / sliding window / softcap / q-k norm + KV cache
(port of ``repro.models.attention``).

* :func:`attention` is the prefill (full-sequence) attention.  Its core is
  K6, :func:`repro_torch.kernels.flash_attention.ops.mha`: the CUDA kernel
  on the card, its plain version on the CPU.  The JAX package has two
  jnp paths here, a direct one and a KV-blocked scan for long sequences;
  it chooses between them only to bound memory, and both compute what the
  kernel computes, so the port has one path.
* :func:`decode_attention` is one-token decode against a cache.  Its
  validity mask (``idx <= pos``, or the ring age on windowed layers) is
  not K6's right-aligned mask, and the JAX package computes it outside any
  Pallas kernel too, so it stays plain PyTorch.  Unlike the JAX package,
  it writes the new token's K / V into the cache tensors in place.

Self-attention only: cross-attention (``kv_x``) belongs to the enc-dec
family, which is not ported yet.  Positions must be consecutive (every
caller passes ``0..S-1``): RoPE reads them, and the masks are the
kernel's, which align queries to keys by index.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.layers import dense_init, rms_norm, softcap

Pytree = Any

__all__ = [
    "AttnConfig",
    "attn_init",
    "rope",
    "attention",
    "decode_attention",
    "decode_attention_shardmap",
    "KVCache",
    "make_cache",
]


class AttnConfig(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    window: Optional[int] = None          # None => full causal
    softcap: Optional[float] = None
    qk_norm: bool = False
    causal: bool = True                   # False for encoder / cross attn


def attn_init(gen: torch.Generator, L: int, d_model: int, cfg: AttnConfig,
              dtype) -> Pytree:
    """Parameters for L stacked layers."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (L, d_model, H * hd), dtype),
        "wk": dense_init(gen, (L, d_model, K * hd), dtype),
        "wv": dense_init(gen, (L, d_model, K * hd), dtype),
        "wo": dense_init(gen, (L, H * hd, d_model), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((L, hd), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((L, hd), dtype=dtype, device=gen.device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Apply rotary embedding to the first ``fraction`` of each head, with
    float32 angles.

    x: (B, S, H, hd); positions: (B, S) or (S,).
    """
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    f32 = torch.float32
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.pow(torch.tensor(theta, dtype=f32, device=x.device),
                      -torch.arange(0, half, dtype=f32, device=x.device) / half)
    if positions.ndim == 1:
        ang = positions[:, None].to(f32) * freqs[None, :]      # (S, half)
        ang = ang[None, :, None, :]                             # (1,S,1,half)
    else:
        ang = positions[..., None].to(f32) * freqs              # (B,S,half)
        ang = ang[:, :, None, :]                                # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].to(f32), xr[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# core attention (prefill)
# ---------------------------------------------------------------------------


def _project(p: Pytree, x: torch.Tensor, cfg: AttnConfig, compute_dtype,
             positions: torch.Tensor):
    """q (B,S,H,hd), k and v (B,S,K,hd) in the compute dtype, normed and
    rotated as the config says."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    q = (xc @ p["wq"].to(compute_dtype)).view(B, S, H, hd)
    k = (xc @ p["wk"].to(compute_dtype)).view(B, S, K, hd)
    v = (xc @ p["wv"].to(compute_dtype)).view(B, S, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_fraction > 0:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attention(p: Pytree, x: torch.Tensor, cfg: AttnConfig, compute_dtype,
              positions: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full self-attention over a (B, S, D) block, through K6.

    Returns the (B, S, D) output and, with ``return_kv``, the unexpanded
    ``(k, v)`` tensors (B, S, K, hd) a KV cache stores.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project(p, x, cfg, compute_dtype, positions)
    o = flash.mha(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=cfg.causal, window=cfg.window, softcap=cfg.softcap)
    out = o.reshape(B, S, -1) @ p["wo"].to(compute_dtype)
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Per-layer-stack KV cache.

    k, v: (L, B, C, K, hd) where C = cache length (= min(window, seq) for
    windowed layers — a RING buffer indexed mod C — else seq).
    """

    k: torch.Tensor
    v: torch.Tensor

    @property
    def length(self) -> int:
        return self.k.shape[2]


def make_cache(L: int, B: int, C: int, cfg: AttnConfig, dtype,
               device=None) -> KVCache:
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((L, B, C, K, hd), dtype=dtype, device=device),
        v=torch.zeros((L, B, C, K, hd), dtype=dtype, device=device),
    )


def decode_attention_shardmap(*args, **kwargs):
    """Flash-decoding over a sequence-sharded cache across devices: waits
    for the multi-GPU slice (ROADMAP queue A item 9)."""
    raise NotImplementedError(
        "decode_attention_shardmap needs one lane per GPU over "
        "torch.distributed (ROADMAP queue A item 9)")


def decode_attention(p: Pytree, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int, cfg: AttnConfig,
                     compute_dtype):
    """One-token decode for a single layer.

    x: (B, 1, D); cache_k/v: (B, C, K, hd); pos: the absolute position of
    the new token.  For windowed layers the cache is a ring (C == window)
    written at ``pos % C``; otherwise linear (C == max seq).  The new K / V
    are written into ``cache_k`` / ``cache_v`` in place.

    Returns (out (B,1,D), cache_k, cache_v).
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C = cache_k.shape[1]
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project(p, x, cfg, compute_dtype, pvec)

    slot = pos % C if cfg.window is not None else min(pos, C - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    # Validity of cache slots: ring => last `window` positions; linear => <= pos.
    idx = torch.arange(C, device=x.device)
    if cfg.window is not None:
        age = (slot - idx) % C           # 0 == newest
        valid = age <= min(pos, C - 1)
    else:
        valid = idx <= pos

    qg = q.reshape(B, K, H // K, hd)
    kc = cache_k.to(compute_dtype)
    vc = cache_v.to(compute_dtype)
    logits = torch.einsum("bkgh,btkh->bkgt", qg, kc).float()
    logits = logits / math.sqrt(hd)
    logits = softcap(logits, cfg.softcap)
    logits = logits.masked_fill(~valid, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(compute_dtype)
    o = torch.einsum("bkgt,btkh->bkgh", w, vc).reshape(B, 1, H * hd)
    out = o @ p["wo"].to(compute_dtype)
    return out, cache_k, cache_v
