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

Self- and cross-attention.  With ``kv_x`` (the enc-dec decoder's
cross-attention) K and V are projected from ``kv_x``, nothing is rotated
and nothing is masked: queries (B, S) read every one of the T source
positions, S and T unrelated.  A config with ``causal=False`` and no
``kv_x`` (the enc-dec encoder) is bidirectional self-attention, rotated.
Either way the core is one call of K6.  Positions must be consecutive
(every caller passes ``0..S-1``): RoPE reads them, and the masks are the
kernel's, which align queries to keys by index.

:func:`decode_attention_shardmap` is flash-decoding over a cache whose
sequence is sharded over the model mesh's ``model`` axis (the JAX
package's ``shard_map`` body): each rank attends over its own slice and
the ranks merge their partial softmaxes with one MAX and two SUM
all-reduces (``launch.mesh.ModelMesh``'s collectives).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch._tree import resolve_device
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models.layers import (_active_mesh, dense_init, rms_norm,
                                       softcap)

Pytree = Any

__all__ = [
    "AttnConfig",
    "attn_init",
    "rope",
    "attention",
    "decode_attention",
    "decode_attention_shardmap",
    "flash_decode_takes",
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
             positions: torch.Tensor, kv_x: Optional[torch.Tensor] = None):
    """q (B,S,H,hd), k and v (B,T,K,hd) in the compute dtype, normed and
    rotated as the config says; K and V from ``kv_x`` when it is given
    (T its length; then nothing is rotated)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    sc = xc if kv_x is None else kv_x.to(compute_dtype)
    T = sc.shape[1]
    q = (xc @ p["wq"].to(compute_dtype)).view(B, S, H, hd)
    k = (sc @ p["wk"].to(compute_dtype)).view(B, T, K, hd)
    v = (sc @ p["wv"].to(compute_dtype)).view(B, T, K, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_fraction > 0 and kv_x is None:  # no RoPE on cross-attn
        q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attention(p: Pytree, x: torch.Tensor, cfg: AttnConfig, compute_dtype,
              positions: Optional[torch.Tensor] = None,
              kv_x: Optional[torch.Tensor] = None,
              return_kv: bool = False):
    """Full attention over a (B, S, D) block, through K6: self-attention,
    or cross-attention over the (B, T, D) ``kv_x`` (unmasked, unrotated).

    Returns the (B, S, D) output and, with ``return_kv``, the unexpanded
    ``(k, v)`` tensors (B, T, K, hd) a KV cache stores.
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project(p, x, cfg, compute_dtype, positions, kv_x)
    o = flash.mha(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=cfg.causal and kv_x is None, window=cfg.window,
                  softcap=cfg.softcap)
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
    """Zeroed ``(L, B, C, K, hd)`` caches on ``device`` (default CUDA;
    raises without it)."""
    K, hd, device = cfg.n_kv_heads, cfg.head_dim, resolve_device(device)
    return KVCache(
        k=torch.zeros((L, B, C, K, hd), dtype=dtype, device=device),
        v=torch.zeros((L, B, C, K, hd), dtype=dtype, device=device),
    )


def flash_decode_takes(cfg: AttnConfig, sh, seq_len: int, mesh=None
                       ) -> bool:
    """Whether :func:`decode_attention_shardmap` serves a layer of ``cfg``
    over a cache of ``seq_len`` positions under ``mesh`` (default: the
    active model mesh): a mesh with ``sh.tp`` among its axes, no window,
    and ``seq_len`` a multiple of the model axis' size (where the JAX
    package's body returns None, this is false)."""
    m = _active_mesh() if mesh is None else mesh
    if m is None or cfg.window is not None or sh.tp not in m.shape:
        return False
    return seq_len % m.shape[sh.tp] == 0


def decode_attention_shardmap(p: Pytree, x: torch.Tensor,
                              cache_k: torch.Tensor, cache_v: torch.Tensor,
                              pos, cfg: AttnConfig, sh, compute_dtype, *,
                              seq_len: Optional[int] = None):
    """Flash-decoding over a sequence-sharded cache (the JAX package's
    ``shard_map`` body, ``repro.models.attention``).

    Under the active model mesh each rank holds its block as the body's
    ``in_specs`` give it: ``p`` the layer's projections whole, ``x``
    (B, 1, D) and ``cache_k`` / ``cache_v`` (B, C / tp, K, hd) this rank's
    rows (which rows a rank decodes is the caller's data parallelism) and
    its model rank's slice of the ``seq_len`` = C cache positions
    (default: the block's length times tp).  Each rank

      1. writes the new K / V in place at ``pos % (C / tp)`` if it owns
         position ``pos`` (no communication);
      2. takes its logits over its slice, masked by ``base + idx <= pos``;
      3. merges with the other model ranks: the max all-reduced (MAX;
         a rank with no valid slot holds -inf, and ``m_safe`` keeps its
         exponentials at 0), the softmax sum and the unnormalised output
         all-reduced (SUM), then one division.

    Returns (out (B, 1, D), cache_k, cache_v), or None where the JAX
    package's body does (:func:`flash_decode_takes` false): then the
    caller decodes unsharded.
    """
    m = _active_mesh()
    C_loc = cache_k.shape[1]
    tp = sh.tp
    if m is None or tp not in m.shape:
        return None
    n = m.shape[tp]
    C = C_loc * n if seq_len is None else int(seq_len)
    if not flash_decode_takes(cfg, sh, C, m):
        return None
    if C != C_loc * n:
        raise ValueError(f"a cache of {C} positions over {n} model ranks "
                         f"is {C // n} a rank, not {C_loc}")
    pos = int(pos)
    rank = m.coords[tp]
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project(p, x, cfg, compute_dtype, pvec)

    # 1. only the owner rank writes its slice
    if pos // C_loc == rank:
        cache_k[:, pos % C_loc] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos % C_loc] = v[:, 0].to(cache_v.dtype)

    # 2. local logits over this rank's slice
    idx = rank * C_loc + torch.arange(C_loc, device=x.device)
    valid = idx <= pos
    qg = q.reshape(B, K, H // K, hd)
    logits = torch.einsum("bkgh,btkh->bkgt", qg,
                          cache_k.to(compute_dtype)).float()
    logits = softcap(logits / math.sqrt(hd), cfg.softcap)
    logits = logits.masked_fill(~valid, float("-inf"))

    # 3. the merge: max, then the sums of p and p v
    m_glob = m.all_reduce(logits.amax(dim=-1), tp, "max")
    m_safe = torch.where(torch.isfinite(m_glob), m_glob,
                         torch.zeros_like(m_glob))
    p_ = torch.exp(logits - m_safe[..., None]).masked_fill(~valid, 0.0)
    o_loc = torch.einsum("bkgt,btkh->bkgh", p_.to(compute_dtype),
                         cache_v.to(compute_dtype)).float()
    l_glob = m.all_reduce(p_.sum(dim=-1), tp, "sum")
    o_glob = m.all_reduce(o_loc, tp, "sum")
    o = o_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    o = o.reshape(B, 1, H * hd).to(compute_dtype)
    return o @ p["wo"].to(compute_dtype), cache_k, cache_v


def decode_attention(p: Pytree, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos, cfg: AttnConfig,
                     compute_dtype):
    """One-token decode for a single layer.

    x: (B, 1, D); cache_k/v: (B, C, K, hd); pos: the absolute position of
    the new token, an int shared by every row, or a ``(B,)`` int32 tensor
    of per-row positions (read on the device, never on the host).  For
    windowed layers the cache is a ring (C == window) written at
    ``pos % C``; otherwise linear (C == max seq), written at
    ``min(pos, C - 1)``.  Per-row positions take linear caches only (paged
    decode rejects ring layers).  The new K / V are written into
    ``cache_k`` / ``cache_v`` in place, one indexed write over the rows.

    Returns (out (B,1,D), cache_k, cache_v).
    """
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    C = cache_k.shape[1]
    idx = torch.arange(C, device=x.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if cfg.window is not None:
            raise ValueError("per-row positions need a linear cache; a "
                             "windowed (ring) layer takes one position")
        pos = pos.to(device=x.device, dtype=torch.int32)
        q, k, v = _project(p, x, cfg, compute_dtype, pos[:, None])
        rows = torch.arange(B, device=x.device)
        slot = torch.clamp(pos, max=C - 1).long()
        cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
        valid = (idx[None, :] <= pos[:, None])[:, None, None, :]
    else:
        pos = int(pos)
        pvec = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q, k, v = _project(p, x, cfg, compute_dtype, pvec)
        slot = pos % C if cfg.window is not None else min(pos, C - 1)
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
        # Validity of cache slots: ring => last `window` positions;
        # linear => <= pos.
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
