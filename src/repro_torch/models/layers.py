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
``with_sharding_constraint``) constrains GSPMD's partitioner; the port has
none, so :func:`shard` returns its input (see there).

The sharded step (``with mesh.spmd():``, :func:`_spmd_mesh`) is the
port's counterpart of GSPMD's partitioning: the models run explicitly
SPMD, each leaf of a parameter tree this rank's block by its spec, and
the functions below insert the collectives:

* an FSDP entry (``sh.fsdp``) is all-gathered before use
  (:func:`fsdp_gather`), its gradient reduce-scattered back;
* ``P(.., fs, tp)`` weights are column-parallel (their input passes
  :func:`tp_copy`, whose gradient is summed over ``tp``), ``P(.., tp,
  fs)`` weights row-parallel (:func:`tp_sum` adds the partial products);
  the residual stream stays whole on every ``tp`` rank;
* ``embed`` ``P(tp, fs)`` is a vocab-parallel lookup
  (:func:`embed_lookup`) and the LM head ``P(fs, tp)`` a vocab-parallel
  cross-entropy (:func:`chunked_ce_loss`) or logits gather
  (:func:`gather_logits`);
* an RMSNorm over a ``tp``-split width sums its squares over ``tp``
  (:func:`rms_norm_tp`);
* the loss's sums run over the batch axes (the batch's rows are split
  over them).

With no active mesh every function is the unsharded one, bit for bit.
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
    "shard",
    "axes",
    "rms_norm",
    "softcap",
    "cross_entropy",
    "dense_init",
    "embed_init",
    "mlp_init",
    "mlp_apply",
    "chunked_ce_loss",
    "remat_call",
    "layer_specs",
    "fsdp_gather",
    "tp_info",
    "tp_copy",
    "tp_sum",
    "tp_gather",
    "batch_entry",
    "embed_lookup",
    "gather_logits",
    "rms_norm_tp",
    "cache_group_block",
    "kv_to_layout",
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


# The default plan, for models called without an explicit one.
axes = ShardPlan()


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """The JAX package's sharding constraint ``P(*spec)`` on ``x``: ``x``
    itself.  A constraint never changes a value, and the port has no
    partitioner to steer: under ``ModelMesh.spmd()`` every tensor already
    is this rank's block by the spec trees, and the functions below place
    the collectives explicitly."""
    del spec
    return x


# The model meshes made active by ``with mesh:``, innermost last.
_MESHES: list = []


def _active_mesh():
    """The model mesh installed by ``with mesh:``, or None."""
    return _MESHES[-1] if _MESHES else None


def _spmd_mesh():
    """The active model mesh when it runs the sharded step
    (``with mesh.spmd():``), else None."""
    m = _active_mesh()
    return m if m is not None and getattr(m, "spmd_active", False) else None


def layer_specs(specs: Pytree, lead: int = 1) -> Pytree:
    """A spec tree with its ``lead`` stacked dims dropped (one layer's)."""
    if isinstance(specs, dict):
        return {k: layer_specs(v, lead) for k, v in specs.items()}
    return P(*specs.entries[lead:])


def _fsdp_leaf(x, spec, mesh, fs):
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if fs in names:
            x = mesh.gather_entry(x, fs, d)
    return x


def fsdp_gather(tree: Pytree, specs: Pytree, sh: "ShardPlan") -> Pytree:
    """Every leaf of ``tree`` all-gathered over the FSDP axis where its
    spec names it (the JAX package's layout leaves ``tp`` blocks local);
    outside the sharded step, ``tree`` itself."""
    m = _spmd_mesh()
    if m is None or sh.fsdp is None or m.size(sh.fsdp) == 1:
        return tree
    if isinstance(tree, dict):
        return {k: fsdp_gather(v, specs[k], sh) for k, v in tree.items()}
    return _fsdp_leaf(tree, specs, m, sh.fsdp)


def tp_info(sh: Optional["ShardPlan"]) -> Tuple[int, int]:
    """(size, rank) of the tensor-parallel axis in the sharded step, or
    (1, 0)."""
    m = _spmd_mesh()
    if m is None or sh is None or sh.tp not in m.shape:
        return 1, 0
    return m.shape[sh.tp], m.coords[sh.tp]


def tp_copy(x: torch.Tensor, sh) -> torch.Tensor:
    """A value every ``tp`` rank holds, entering a ``tp``-partial path:
    its gradient is summed over ``tp`` (Megatron's f)."""
    m = _spmd_mesh()
    return x if m is None else m.copy(x, sh.tp)


def tp_sum(x: torch.Tensor, sh) -> torch.Tensor:
    """The sum of ``tp``-partial values (a row-parallel product), whole
    on every ``tp`` rank; its gradient passes through (Megatron's g)."""
    m = _spmd_mesh()
    return x if m is None else m.all_reduce(x, sh.tp, "sum")


def tp_gather(x: torch.Tensor, sh, dim: int) -> torch.Tensor:
    """The ``tp`` ranks' blocks of ``x`` concatenated on ``dim``."""
    m = _spmd_mesh()
    return x if m is None else m.all_gather(x, sh.tp, dim)


def batch_entry(sh) -> Tuple[str, ...]:
    """The axes the batch's rows are split over in the sharded step (the
    plan's batch axes the mesh has; none when the mesh replicates the
    batch, or outside the sharded step)."""
    m = _spmd_mesh()
    if m is None or sh is None or not m.batch_sharded:
        return ()
    return tuple(a for a in sh.dp if a in m.shape)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, sh
                 ) -> torch.Tensor:
    """``table[tokens]``; in the sharded step ``table`` is this ``tp``
    rank's rows of the vocabulary (``P(tp, ...)``, FSDP-gathered): each
    rank looks up the tokens it holds, zero elsewhere, and the ranks sum."""
    n, r = tp_info(sh)
    if n == 1:
        return table[tokens.long()]
    Vl = table.shape[0]
    local = tokens.long() - r * Vl
    inside = (local >= 0) & (local < Vl)
    x = table[local.clamp(0, Vl - 1)] * inside[..., None].to(table.dtype)
    return tp_sum(x, sh)


def gather_logits(logits: torch.Tensor, sh, vocab: int) -> torch.Tensor:
    """Whole-vocabulary logits from this ``tp`` rank's columns (the
    ranks' blocks gathered, padding past ``vocab`` cut)."""
    n, _ = tp_info(sh)
    if n == 1:
        return logits
    return tp_gather(logits, sh, -1)[..., :vocab]


def rms_norm_tp(x: torch.Tensor, w: torch.Tensor, sh,
                eps: float = 1e-5) -> torch.Tensor:
    """:func:`rms_norm` over a width split over ``tp`` (``x`` and ``w``
    this rank's columns): the sum of squares is summed over the ranks,
    and so is its gradient (each rank scales its own columns)."""
    n, _ = tp_info(sh)
    if n == 1:
        return rms_norm(x, w, eps)
    m = _spmd_mesh()
    dt = x.dtype
    x = x.float()
    ss = m.all_reduce(m.copy((x * x).sum(dim=-1, keepdim=True), sh.tp),
                      sh.tp, "sum")
    x = x * torch.rsqrt(ss / (x.shape[-1] * n) + eps)
    return (x * w.float()).to(dt)


def cache_group_block(group: dict, spec: "P", mesh) -> dict:
    """A whole cache group's ``k`` / ``v`` (``(L, B, C, K, hd)``) cut to
    this rank's block by ``spec``, its global length kept as ``seq_len``
    (the sharded decode reads the layout from it)."""
    out = mesh.shard({"k": group["k"], "v": group["v"]},
                     {"k": spec, "v": spec})
    out["seq_len"] = group["k"].shape[2]
    return out


def kv_to_layout(x: torch.Tensor, spec: "P", sh) -> torch.Tensor:
    """A prefill's ``(L, B_loc, C, K, hd)`` K or V (this rank's rows,
    every position) in the cache layout ``spec``: the rows gathered over
    the batch axes where ``spec`` does not split them, the sequence cut
    to this rank's block where it does."""
    m = _spmd_mesh()
    rows = batch_entry(sh)
    if rows and m._axes(spec[1]) != rows:
        if m._axes(spec[1]):
            raise ValueError(f"cannot lay rows split over {rows} out "
                             f"as {spec}")
        x = m.gather_entry(x, rows, 1)
    k = m.size(spec[2])
    if k > 1:
        w = x.shape[2] // k
        x = x.narrow(2, m.index(spec[2]) * w, w)
    return x


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy, the logits in float32 for a stable
    softmax; with ``mask``, the mean over its weight (at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


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


def mlp_apply(p: Pytree, x: torch.Tensor, compute_dtype,
              sh: Optional[ShardPlan] = None) -> torch.Tensor:
    """SwiGLU: down(silu(gate(x)) * up(x)); ``p`` leaves are one layer's (no
    L dim).  In the sharded step gate and up are column-parallel and down
    row-parallel over ``tp`` (``p`` FSDP-gathered)."""
    x = x.to(compute_dtype)
    if sh is not None:
        x = tp_copy(x, sh)
    h = x @ p["w_gate"].to(compute_dtype)
    u = x @ p["w_up"].to(compute_dtype)
    out = (F.silu(h) * u) @ p["w_down"].to(compute_dtype)
    return out if sh is None else tp_sum(out, sh)


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


def _chunk_nll_tp(h, head, labels, mask, final_softcap, sh, vocab):
    """:func:`_chunk_nll` with ``head`` this ``tp`` rank's vocabulary
    columns: the logsumexp's max and sum of exponentials, and the gold
    logit (on the rank that holds its column), summed over ``tp``."""
    m = _spmd_mesh()
    n, r = tp_info(sh)
    logits = softcap(tp_copy(h, sh) @ head, final_softcap).float()
    Vl = logits.shape[-1]
    if (r + 1) * Vl > vocab:    # GSPMD's padding past the vocabulary
        col = r * Vl + torch.arange(Vl, device=logits.device)
        logits = logits.masked_fill(col >= vocab, float("-inf"))
    top = m.all_reduce(logits.detach().amax(dim=-1), sh.tp, "max")
    se = m.all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1),
                      sh.tp, "sum")
    logz = top + torch.log(se)
    local = labels.long() - r * Vl
    inside = (local >= 0) & (local < Vl)
    gold = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None]
                        )[..., 0]
    gold = m.all_reduce(torch.where(inside, gold, torch.zeros_like(gold)),
                        sh.tp, "sum")
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, mask: Optional[torch.Tensor], *,
                    final_softcap: Optional[float] = None, chunk: int = 512,
                    remat: bool = True, sh: Optional[ShardPlan] = None,
                    vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy of the LM head over ``hidden``, in sequence
    chunks so that the ``(B, S, V)`` logits never exist at once.

    hidden: (B, S, D); head: (D, V); labels: (B, S) int; mask: optional
    (B, S).  ``S // chunk`` chunks, fewer until they divide S (vlm's text
    length need not be a multiple).  With ``remat`` each chunk runs
    under ``torch.utils.checkpoint``: its float32 logits are recomputed in
    the backward (at a 128,256-entry vocab and a 4 x 512 chunk they are
    1.05 GB).  In the sharded step (``sh`` given) ``head`` is this ``tp``
    rank's columns of a ``vocab``-entry head, ``hidden`` and ``labels``
    this rank's rows, and the NLL and token sums run over the batch axes:
    the loss is the global batch's on every rank."""
    B, S, _ = hidden.shape
    nchunk = max(S // chunk, 1)
    while S % nchunk:
        nchunk -= 1
    csz = S // nchunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    split = sh is not None and tp_info(sh)[0] > 1
    fn, extra = ((_chunk_nll_tp, (sh, vocab or head.shape[-1])) if split
                 else (_chunk_nll, ()))
    for c in range(nchunk):
        part = slice(c * csz, (c + 1) * csz)
        nll, m = remat_call(fn, hidden[:, part], head,
                            labels[:, part], mask[:, part], final_softcap,
                            *extra, enabled=remat)
        tot, cnt = tot + nll, cnt + m
    if sh is not None:
        mesh, rows = _spmd_mesh(), batch_entry(sh)
        if mesh is not None and rows:
            tot, cnt = mesh.sum_entry(tot, rows), mesh.sum_entry(cnt, rows)
    return tot / torch.clamp(cnt, min=1.0)
