"""Shared building blocks: partition specs and the shard plan, norms,
softcap, initializers, the SwiGLU MLP and the sequence-chunked LM-head
loss (port of ``repro.models.layers``).

Models are plain functions over parameter trees (dicts of tensors), as in
the JAX package; stacked layers carry a leading ``(L, ...)`` dimension, so
the JAX package's parameters carry over unchanged.  Initializers draw from
an explicit ``torch.Generator``; they do not reproduce ``jax.random``
streams (parity tests carry the JAX package's parameters over with
``models.zoo.params_from_numpy``).

Sharding.  :class:`P` is the port's partition spec (one entry per
dimension: ``None``, an axis name, or a tuple of names), and
:class:`ShardPlan` names the axes' roles, as in the JAX package; the
models' ``param_specs`` and ``cache_specs`` are trees of ``P`` equal to
the JAX package's.  A model mesh (``launch.mesh.ModelMesh``) is made
active with ``with mesh:``, as a JAX mesh is, and :func:`_active_mesh`
reads it; the explicit-collective bodies (flash-decoding, expert-parallel
MoE) take their branch only under one.  The JAX package's ``shard`` (a
``with_sharding_constraint``) has no counterpart: without GSPMD there is
no partitioner for it to constrain.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Pytree = Any

__all__ = [
    "P",
    "ShardPlan",
    "rms_norm",
    "softcap",
    "dense_init",
    "embed_init",
    "mlp_init",
    "mlp_apply",
    "chunked_ce_loss",
    "remat_call",
]


class P:
    """A partition spec: one entry per dimension of a tensor, each
    ``None`` (replicated), an axis name, or a tuple of axis names (the
    dimension split over their product, the first the major).  The port's
    own counterpart of ``jax.sharding.PartitionSpec``, and normalised as
    it is (a one-name tuple is the name, an empty one None); a leaf of the
    port's trees (not a tuple), so a tree of specs maps like any other."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(self._entry(e) for e in entries)

    @staticmethod
    def _entry(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


class ShardPlan:
    """Named axis roles for a parallelism plan (``configs.ParallelConfig``).

    dp:   batch axes (a tuple: the pod axis joins it on multi-pod meshes)
    tp:   tensor-parallel axis (heads / d_ff / vocab / experts / sequence)
    fsdp: parameter-sharding axis (None: replicated parameters, pure DP)
    """

    def __init__(self, dp: Tuple[str, ...] = ("data",), tp: str = "model",
                 fsdp: Optional[str] = "data"):
        self.dp, self.tp, self.fsdp = tuple(dp), tp, fsdp

    @classmethod
    def from_parallel(cls, par) -> "ShardPlan":
        return cls(dp=par.batch_axes, tp=par.model_axis, fsdp=par.fsdp_axis)


# The model meshes made active by ``with mesh:``, innermost last.
_MESHES: list = []


def _active_mesh():
    """The model mesh installed by ``with mesh:``, or None."""
    return _MESHES[-1] if _MESHES else None


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


def remat_call(fn, *args, enabled: bool = True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``enabled`` and
    autograd is recording: its activations are recomputed in the backward
    instead of kept (the JAX package's ``jax.checkpoint`` with
    ``nothing_saveable``)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _chunk_nll(h, head, labels, mask, final_softcap):
    """Sum of one chunk's masked token NLL and of its mask: logits in the
    head's dtype, softcapped, then float32 for the logsumexp."""
    logits = softcap(h @ head, final_softcap).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, mask: Optional[torch.Tensor], *,
                    final_softcap: Optional[float] = None, chunk: int = 512,
                    remat: bool = True) -> torch.Tensor:
    """Mean token cross-entropy of the LM head over ``hidden``, in sequence
    chunks so that the ``(B, S, V)`` logits never exist at once.

    hidden: (B, S, D); head: (D, V); labels: (B, S) int; mask: optional
    (B, S).  ``S // chunk`` chunks, fewer until they divide S (vlm's text
    length need not be a multiple).  With ``remat`` each chunk runs
    under ``torch.utils.checkpoint``: its float32 logits are recomputed in
    the backward (at a 128,256-entry vocab and a 4 x 512 chunk they are
    1.05 GB)."""
    B, S, _ = hidden.shape
    nchunk = max(S // chunk, 1)
    while S % nchunk:
        nchunk -= 1
    csz = S // nchunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nchunk):
        part = slice(c * csz, (c + 1) * csz)
        nll, m = remat_call(_chunk_nll, hidden[:, part], head,
                            labels[:, part], mask[:, part], final_softcap,
                            enabled=remat)
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp(cnt, min=1.0)
