"""Decoder-only LM for the dense, MoE and VLM families (port of
``repro.models.transformer.DecoderLM``).

Structure: token (+ optional patch-prefix) embedding -> layer GROUPS ->
final norm -> (tied) LM head.  A "group" is the layer repeat unit: 1 for
uniform archs, 2 for gemma2's (local, global) alternation.  Parameters
keep the JAX package's layout, each group kind's layers stacked on a
leading ``(NG, ...)`` dim, so the JAX package's weights carry over
unchanged.  The JAX package scans the groups; the port loops over them in
Python, and under ``cfg.remat`` runs each group of ``forward`` under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).

An MoE layer (``n_experts > 0``) takes ``models.moe.moe_apply`` (bulk-steal
routing) where a dense one takes the SwiGLU MLP: capacity factor 1.25 in
``forward`` and ``prefill``, 2.0 in ``decode_step``, as in the JAX package.
The VLM family prefixes the text with ``patches`` projected by
``patch_proj``; ``loss_fn`` scores the text positions only.

Prefill and training attention run through K6 (``models.attention
.attention``), whose CUDA route has a gradient (its plain version's);
decode attention is plain PyTorch.  ``decode_step`` writes the new
token's K / V into the cache in place.

Sharding.  ``param_specs`` and ``cache_specs`` are the JAX package's
GSPMD layouts (trees of ``layers.P``, equal leaf for leaf).  What runs
sharded is the two explicit-collective bodies, under an active model mesh
(``launch.mesh.ModelMesh``): ``shard_params`` keeps this rank's experts
(``moe_impl="ep_shardmap"``) and ``shard_cache`` this rank's slice of the
global layers' cache sequence (``decode_impl="flash_shardmap"``, caches of
at least ``_SEQ_SHARD_MIN`` positions); ``decode_step`` then takes
flash-decoding on those layers, as the JAX package's does.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._tree import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (AttnConfig, attention, attn_init,
                                          decode_attention)
from repro_torch.models.layers import (P, ShardPlan, chunked_ce_loss,
                                       dense_init, embed_init, mlp_apply,
                                       mlp_init, remat_call, rms_norm,
                                       softcap)

Pytree = Any

__all__ = ["DecoderLM"]

_LOSS_CHUNK = 512           # sequence chunk of the LM-head loss
_CAPACITY = 1.25            # MoE capacity factor over a prompt or batch
_DECODE_CAPACITY = 2.0      # ... and over one decode token a row
_SEQ_SHARD_MIN = 8192       # decode caches at/above this length shard on seq


def _attn_cfg(cfg: ModelConfig, *, local: bool) -> AttnConfig:
    return AttnConfig(
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd,
        rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction,
        window=cfg.window if local else None,
        softcap=cfg.attn_logit_softcap,
        qk_norm=cfg.qk_norm,
        causal=True,
    )


class DecoderLM:
    """Functional model bundle for one config (dense / moe / vlm)."""

    def __init__(self, cfg: ModelConfig, sh: Optional[ShardPlan] = None):
        self.cfg = cfg
        self.sh = sh or ShardPlan()
        # Layer grouping: gemma2 alternates (local, global).
        if cfg.local_global_every:
            self.group = 2
            self.layer_kinds = ("local", "global")
        else:
            self.group = 1
            self.layer_kinds = ("local" if cfg.window else "global",)
        assert cfg.n_layers % self.group == 0
        self.n_groups = cfg.n_layers // self.group
        self.dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Pytree:
        """Random parameters on the generator's device (normal x 0.02,
        norms at one)."""
        cfg, dev = self.cfg, gen.device
        NG, D, Vp = self.n_groups, cfg.d_model, cfg.padded_vocab

        def ones(*shape):
            return torch.ones(shape, dtype=self.dtype, device=dev)

        blocks = {}
        for gi, kind in enumerate(self.layer_kinds):
            acfg = _attn_cfg(cfg, local=(kind == "local"))
            sub = {"ln1": ones(NG, D), "ln2": ones(NG, D),
                   "attn": attn_init(gen, NG, D, acfg, self.dtype)}
            if cfg.sandwich_norm:
                sub["ln1_post"] = ones(NG, D)
                sub["ln2_post"] = ones(NG, D)
            if cfg.n_experts:
                sub["moe"] = moe_mod.moe_init(gen, NG, D, cfg.n_experts,
                                              cfg.d_ff_expert, self.dtype)
            else:
                sub["mlp"] = mlp_init(gen, NG, D, cfg.d_ff, self.dtype)
            blocks[f"g{gi}"] = sub
        params = {
            "embed": embed_init(gen, Vp, D, self.dtype),
            "blocks": blocks,
            "final_norm": ones(D),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (D, Vp), self.dtype)
        if cfg.family == "vlm":
            params["patch_proj"] = dense_init(gen, (cfg.frontend_dim, D),
                                              self.dtype)
        return params

    # ------------------------------------------------------------- specs

    def param_specs(self) -> Pytree:
        """The JAX package's GSPMD layout of ``init``'s tree."""
        cfg, sh = self.cfg, self.sh
        tp, fs = sh.tp, sh.fsdp
        blocks = {}
        for gi, _ in enumerate(self.layer_kinds):
            attn = {"wq": P(None, fs, tp), "wk": P(None, fs, tp),
                    "wv": P(None, fs, tp), "wo": P(None, tp, fs)}
            if cfg.qk_norm:
                attn["q_norm"] = P(None, None)
                attn["k_norm"] = P(None, None)
            sub = {"ln1": P(None, None), "ln2": P(None, None), "attn": attn}
            if cfg.sandwich_norm:
                sub["ln1_post"] = P(None, None)
                sub["ln2_post"] = P(None, None)
            if cfg.n_experts:
                ep = cfg.n_experts % 16 == 0  # EP when experts divide TP
                sub["moe"] = {
                    "router": P(None, fs, None),
                    "w_gate": P(None, tp, fs, None) if ep
                    else P(None, None, fs, tp),
                    "w_up": P(None, tp, fs, None) if ep
                    else P(None, None, fs, tp),
                    "w_down": P(None, tp, None, fs) if ep
                    else P(None, None, tp, fs),
                }
            else:
                sub["mlp"] = {"w_gate": P(None, fs, tp),
                              "w_up": P(None, fs, tp),
                              "w_down": P(None, tp, fs)}
            blocks[f"g{gi}"] = sub
        specs = {"embed": P(tp, fs), "blocks": blocks, "final_norm": P(None)}
        if not cfg.tie_embeddings:
            specs["lm_head"] = P(fs, tp)
        if cfg.family == "vlm":
            specs["patch_proj"] = P(None, fs)
        return specs

    def cache_specs(self, seq_len: int, batch: int = 0) -> Pytree:
        """The JAX package's GSPMD layout of the cache: batch over dp
        (long caches also their sequence over tp); a batch under 16
        shards its sequence over dp and tp together."""
        sh = self.sh
        specs = {"pos": P()}
        for gi, kind in enumerate(self.layer_kinds):
            C = self.cache_len(kind, seq_len)
            if 0 < batch < 16:
                kv = P(None, None, tuple(sh.dp) + (sh.tp,), None, None)
            elif C >= _SEQ_SHARD_MIN:
                kv = P(None, sh.dp, sh.tp, None, None)
            else:
                kv = P(None, sh.dp, None, None, None)
            specs[f"g{gi}"] = {"k": kv, "v": kv}
        return specs

    def shard_params(self, params, mesh) -> Pytree:
        """This rank's block of ``params`` for the collective bodies: with
        ``moe_impl="ep_shardmap"`` and experts that divide the model axis,
        its model rank's experts; everything else whole."""
        cfg, tp = self.cfg, self.sh.tp
        specs = {}
        if (cfg.n_experts and cfg.moe_impl == "ep_shardmap"
                and tp in mesh.shape and cfg.n_experts % mesh.shape[tp] == 0):
            expert = P(None, tp)           # (NG, E, ...): E over the model
            specs["blocks"] = {g: {"moe": {"w_gate": expert, "w_up": expert,
                                           "w_down": expert}}
                               for g in params["blocks"]}
        return mesh.shard(params, _fill(params, specs))

    def shard_cache(self, cache, mesh) -> Pytree:
        """This rank's block of a (grown) cache for flash-decoding: with
        ``decode_impl="flash_shardmap"``, the global layers' caches of at
        least ``_SEQ_SHARD_MIN`` positions that the model axis divides
        keep this model rank's slice of the sequence, and record their
        length as ``"seq_len"``; the rest stays whole (rows are the
        caller's)."""
        out = dict(cache)
        for gi, kind in enumerate(self.layer_kinds):
            cg = cache[f"g{gi}"]
            C = cg["k"].shape[2]
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            if (self.cfg.decode_impl == "flash_shardmap"
                    and C >= _SEQ_SHARD_MIN
                    and attn_mod.flash_decode_takes(acfg, self.sh, C, mesh)):
                spec = P(None, None, self.sh.tp)
                out[f"g{gi}"] = dict(mesh.shard(cg, {"k": spec, "v": spec}),
                                     seq_len=C)
        return out

    # ----------------------------------------------------------- embedding

    def _embed(self, params, tokens: torch.Tensor,
               patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S_text) tokens [+ (B, P, frontend_dim) patches] -> (B, P +
        S_text, D) in the compute dtype, the projected patches first."""
        x = params["embed"][tokens.long()]               # (B, S, D)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
        if patches is not None:
            pp = patches.to(self.cdtype) @ params["patch_proj"].to(
                self.cdtype)
            x = torch.cat([pp.to(x.dtype), x], dim=1)
        return x.to(self.cdtype)

    def _head(self, params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm -> head -> final softcap -> float32."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        logits = x @ self._head(params).to(self.cdtype)
        return softcap(logits, self.cfg.final_logit_softcap).float()

    # ------------------------------------------------------------- layers

    def _group_params(self, params, g: int) -> Pytree:
        """Group ``g``'s parameters, ``{"g<gi>": that layer's}``."""
        return tree_map(lambda a: a[g], params["blocks"])

    def _layers(self, params):
        """Yield ``(group index, kind index, kind, that layer's params)`` in
        layer order."""
        for g in range(self.n_groups):
            pgroup = self._group_params(params, g)
            for gi, kind in enumerate(self.layer_kinds):
                yield g, gi, kind, pgroup[f"g{gi}"]

    def _ffn(self, pg, h: torch.Tensor, capacity_factor: float):
        """The MLP, or the MoE layer with bulk-steal routing."""
        cfg = self.cfg
        if cfg.n_experts:
            return moe_mod.moe_apply(
                pg["moe"], h, top_k=cfg.top_k, n_experts=cfg.n_experts,
                capacity_factor=capacity_factor, compute_dtype=self.cdtype,
                bulk_steal=cfg.moe_bulk_steal, impl=cfg.moe_impl,
                sh=self.sh)
        return mlp_apply(pg["mlp"], h, self.cdtype)

    def _block(self, pg, x, attn_fn, capacity_factor: float = _CAPACITY):
        """One layer: attention (``attn_fn(params, normed x)``) and MLP or
        MoE, each pre-normed (and post-normed with sandwich norms) on the
        residual."""
        cfg = self.cfg
        a = attn_fn(pg["attn"], rms_norm(x, pg["ln1"], cfg.norm_eps))
        if cfg.sandwich_norm:
            a = rms_norm(a, pg["ln1_post"], cfg.norm_eps)
        x = x + a
        m = self._ffn(pg, rms_norm(x, pg["ln2"], cfg.norm_eps),
                      capacity_factor)
        if cfg.sandwich_norm:
            m = rms_norm(m, pg["ln2_post"], cfg.norm_eps)
        return x + m

    # ------------------------------------------------------------- forward

    def _group_fn(self, x, pgroup, positions):
        """One group's layers, full-sequence attention through K6."""
        for gi, kind in enumerate(self.layer_kinds):
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            x = self._block(pgroup[f"g{gi}"], x, lambda p, h: attention(
                p, h, acfg, self.cdtype, positions=positions))
        return x

    def forward(self, params, tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) tokens [+ patches] -> (B, S_total, D) hidden (after final
        norm); differentiable, each group rematerialized under
        ``cfg.remat``."""
        x = self._embed(params, tokens, patches)
        S = x.shape[1]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        for g in range(self.n_groups):
            x = remat_call(self._group_fn, x, self._group_params(params, g),
                           positions, enabled=self.cfg.remat)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    # --------------------------------------------------------------- loss

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean token cross-entropy of ``batch``: tokens (B, S), labels
        (B, S), optional loss_mask and patches.  The LM head and the CE run
        in sequence chunks (``layers.chunked_ce_loss``), over the text
        positions only when there are patches."""
        patches = batch.get("patches")
        hidden = self.forward(params, batch["tokens"], patches)
        if patches is not None:
            hidden = hidden[:, patches.shape[1]:]
        head = self._head(params).to(self.cdtype)
        return chunked_ce_loss(hidden, head, batch["labels"],
                               batch.get("loss_mask"),
                               final_softcap=self.cfg.final_logit_softcap,
                               chunk=_LOSS_CHUNK, remat=self.cfg.remat)

    # ------------------------------------------------------------- serving

    def cache_len(self, kind: str, seq_len: int) -> int:
        if kind == "local" and self.cfg.window:
            return min(self.cfg.window, seq_len)
        return seq_len

    def make_cache(self, batch: int, seq_len: int, device=None) -> Pytree:
        """Zeroed KV caches, one stack per layer kind, + position, on
        ``device`` (default CUDA; raises without it)."""
        cfg, device = self.cfg, resolve_device(device)
        cache: Dict[str, Any] = {"pos": 0}
        for gi, kind in enumerate(self.layer_kinds):
            shape = (self.n_groups, batch, self.cache_len(kind, seq_len),
                     cfg.n_kv_heads, cfg.hd)
            cache[f"g{gi}"] = {
                "k": torch.zeros(shape, dtype=self.cdtype, device=device),
                "v": torch.zeros(shape, dtype=self.cdtype, device=device)}
        return cache

    def grow_cache(self, cache: Pytree, target_len: int) -> Pytree:
        """Grow a prefill cache for decoding up to ``target_len`` total
        positions.  Global (linear) caches zero-pad on the seq axis; local
        RING caches re-layout from C=min(window, S) to C=min(window,
        target) preserving the ``slot = pos % C`` invariant."""
        pos = int(cache["pos"])
        new = {"pos": pos}
        for gi, kind in enumerate(self.layer_kinds):
            cg = cache[f"g{gi}"]
            C = cg["k"].shape[2]
            C_new = self.cache_len(kind, target_len)
            if C_new <= C:
                new[f"g{gi}"] = cg
                continue
            if kind == "local" and self.cfg.window:
                # ring re-layout: slots hold positions [pos-C, pos)
                p = torch.arange(pos - C, pos, device=cg["k"].device)
                src, dst = p % C, p % C_new
            else:
                src = dst = torch.arange(C, device=cg["k"].device)

            def grow(x):
                out = x.new_zeros(x.shape[:2] + (C_new,) + x.shape[3:])
                out[:, :, dst] = x[:, :, src]
                return out

            new[f"g{gi}"] = {"k": grow(cg["k"]), "v": grow(cg["v"])}
        return new

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor,
                patches: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Pytree]:
        """Forward over the prompt [and its patch prefix, which takes the
        first cache positions]; returns (last-position logits (B,1,V)
        float32, cache)."""
        x = self._embed(params, tokens, patches)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        kvs = {f"g{gi}": ([], []) for gi in range(len(self.layer_kinds))}
        for _, gi, kind, pg in self._layers(params):
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            C = self.cache_len(kind, S)

            def attn_fn(p, h):
                a, (k, v) = attention(p, h, acfg, self.cdtype,
                                      positions=positions, return_kv=True)
                if C < S:  # ring layout: slot = pos % C over the last C steps
                    ridx = torch.arange(S - C, S, device=x.device) % C
                    k = k.new_zeros((B, C) + k.shape[2:]).index_copy_(
                        1, ridx, k[:, S - C:])
                    v = v.new_zeros((B, C) + v.shape[2:]).index_copy_(
                        1, ridx, v[:, S - C:])
                kvs[f"g{gi}"][0].append(k.to(self.cdtype))
                kvs[f"g{gi}"][1].append(v.to(self.cdtype))
                return a

            x = self._block(pg, x, attn_fn)
        cache = {"pos": S}
        for name, (ks, vs) in kvs.items():
            cache[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Pytree]:
        """One-token decode. tokens: (B, 1). Returns (logits (B,1,V) float32,
        cache); the cache's K / V tensors are updated in place.

        ``cache["pos"]`` is one position for every row (an int), or a
        ``(B,)`` int32 tensor of per-row positions on the cache's device —
        each row rotates, writes and attends at its own position, with no
        host read (the counterpart of ``jax.vmap`` of the JAX package's
        ``decode_step`` over batch-1 caches; linear caches only)."""
        x = self._embed(params, tokens)
        pos = cache["pos"]
        if not (isinstance(pos, torch.Tensor) and pos.ndim == 1):
            pos = int(pos)
        for g, gi, kind, pg in self._layers(params):
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            attn_fn = functools.partial(self._decode_attn,
                                        cg=cache[f"g{gi}"], g=g, pos=pos,
                                        acfg=acfg)
            x = self._block(pg, x, attn_fn, _DECODE_CAPACITY)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self._logits(params, x), new_cache

    def _decode_attn(self, p, h, *, cg, g, pos, acfg):
        """One layer's decode attention: flash-decoding on a cache that
        ``shard_cache`` sequence-sharded (its ``seq_len`` recorded), else
        the unsharded ``decode_attention``."""
        if "seq_len" in cg:
            out = attn_mod.decode_attention_shardmap(
                p, h, cg["k"][g], cg["v"][g], pos, acfg, self.sh,
                self.cdtype, seq_len=cg["seq_len"])
            if out is None:
                raise ValueError(
                    "a sequence-sharded cache decodes only under its model "
                    "mesh (with mesh: ...)")
            return out[0]
        return decode_attention(p, h, cg["k"][g], cg["v"][g], pos, acfg,
                                self.cdtype)[0]


def _fill(tree, specs):
    """``specs`` spread to ``tree``'s leaves: a dict of specs names some
    of a dict's entries, and None (or a missing entry) covers a whole
    subtree."""
    if isinstance(tree, dict):
        return {k: _fill(v, (specs or {}).get(k)) for k, v in tree.items()}
    return specs
