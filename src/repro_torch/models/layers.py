"""Shared building blocks: norms, softcap, initializers, the SwiGLU MLP
(port of ``repro.models.layers``).

Models are plain functions over parameter trees (dicts of tensors), as in
the JAX package; stacked layers carry a leading ``(L, ...)`` dimension, so
the JAX package's parameters carry over unchanged.  The port runs on one
card, so it has no ``ShardPlan`` and no ``shard``: the JAX package's
sharding constraints are no-ops without a mesh, and here there is none.
Initializers draw from an explicit ``torch.Generator``; they do not
reproduce ``jax.random`` streams (parity tests carry the JAX package's
parameters over with ``models.zoo.params_from_numpy``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F

Pytree = Any

__all__ = [
    "rms_norm",
    "softcap",
    "dense_init",
    "embed_init",
    "mlp_init",
    "mlp_apply",
]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in float32 and cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype,
               scale: float = 0.02) -> torch.Tensor:
    """Normal(0, 1) x ``scale`` in float32, cast to ``dtype``, on the
    generator's device."""
    return (torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return dense_init(gen, (vocab, dim), dtype)


def mlp_init(gen: torch.Generator, L: int, d_model: int, d_ff: int,
             dtype) -> Pytree:
    """SwiGLU MLP, stacked over L layers."""
    return {
        "w_gate": dense_init(gen, (L, d_model, d_ff), dtype),
        "w_up": dense_init(gen, (L, d_model, d_ff), dtype),
        "w_down": dense_init(gen, (L, d_ff, d_model), dtype),
    }


def mlp_apply(p: Pytree, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x)); ``p`` leaves are one layer's (no
    L dim)."""
    x = x.to(compute_dtype)
    h = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    return (F.silu(h) * u) @ p["w_down"].to(compute_dtype)
