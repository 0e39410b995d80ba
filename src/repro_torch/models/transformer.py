"""Decoder-only LM for the dense family (port of
``repro.models.transformer.DecoderLM``, serving half).

Structure: token embedding -> layer GROUPS -> final norm -> (tied) LM
head.  A "group" is the layer repeat unit: 1 for uniform archs, 2 for
gemma2's (local, global) alternation.  Parameters keep the JAX package's
layout, each group kind's layers stacked on a leading ``(NG, ...)`` dim,
so the JAX package's weights carry over unchanged.  The JAX package scans
the groups under remat; serving takes no gradient, so the port loops over
them in Python.

Prefill attention runs through K6 (``models.attention.attention``);
decode attention is plain PyTorch.  ``decode_step`` writes the new
token's K / V into the cache in place.  MoE layers (``n_experts > 0``) and
the VLM patch prefix wait for their ROADMAP items; ``loss_fn``,
``param_specs`` and ``cache_specs`` wait for training.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (AttnConfig, attention, attn_init,
                                          decode_attention)
from repro_torch.models.layers import (dense_init, embed_init, mlp_apply,
                                       mlp_init, rms_norm, softcap)

Pytree = Any

__all__ = ["DecoderLM"]


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
    """Functional model bundle for one dense decoder config."""

    def __init__(self, cfg: ModelConfig):
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (models/moe.py) wait for ROADMAP "
                f"queue A item 10")
        if cfg.family == "vlm":
            raise NotImplementedError(
                f"{cfg.name}: the VLM patch prefix waits for ROADMAP queue A "
                f"item 10")
        self.cfg = cfg
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
            sub["mlp"] = mlp_init(gen, NG, D, cfg.d_ff, self.dtype)
            blocks[f"g{gi}"] = sub
        params = {
            "embed": embed_init(gen, Vp, D, self.dtype),
            "blocks": blocks,
            "final_norm": ones(D),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (D, Vp), self.dtype)
        return params

    # ----------------------------------------------------------- embedding

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["embed"][tokens.long()]               # (B, S, D)
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                 device=x.device)
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

    def _layers(self, params):
        """Yield ``(group index, kind index, kind, that layer's params)`` in
        layer order."""
        for g in range(self.n_groups):
            for gi, kind in enumerate(self.layer_kinds):
                yield g, gi, kind, tree_map(lambda a: a[g],
                                            params["blocks"][f"g{gi}"])

    def _block(self, pg, x, attn_fn):
        """One layer: attention (``attn_fn(params, normed x)``) and MLP, each
        pre-normed (and post-normed with sandwich norms) on the residual."""
        cfg = self.cfg
        a = attn_fn(pg["attn"], rms_norm(x, pg["ln1"], cfg.norm_eps))
        if cfg.sandwich_norm:
            a = rms_norm(a, pg["ln1_post"], cfg.norm_eps)
        x = x + a
        m = mlp_apply(pg["mlp"], rms_norm(x, pg["ln2"], cfg.norm_eps),
                      self.cdtype)
        if cfg.sandwich_norm:
            m = rms_norm(m, pg["ln2_post"], cfg.norm_eps)
        return x + m

    # ------------------------------------------------------------- forward

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) hidden (after final norm)."""
        x = self._embed(params, tokens)
        S = x.shape[1]
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)
        for _, _, kind, pg in self._layers(params):
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            x = self._block(pg, x, lambda p, h: attention(
                p, h, acfg, self.cdtype, positions=positions))
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    # ------------------------------------------------------------- serving

    def cache_len(self, kind: str, seq_len: int) -> int:
        if kind == "local" and self.cfg.window:
            return min(self.cfg.window, seq_len)
        return seq_len

    def make_cache(self, batch: int, seq_len: int, device=None) -> Pytree:
        """Zeroed KV caches, one stack per layer kind, + position."""
        cfg = self.cfg
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
    def prefill(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
        """Forward over the prompt; returns (last-position logits (B,1,V)
        float32, cache)."""
        x = self._embed(params, tokens)
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
        cache); the cache's K / V tensors are updated in place."""
        x = self._embed(params, tokens)
        pos = int(cache["pos"])
        for g, gi, kind, pg in self._layers(params):
            acfg = _attn_cfg(self.cfg, local=(kind == "local"))
            cg = cache[f"g{gi}"]
            x = self._block(pg, x, lambda p, h: decode_attention(
                p, h, cg["k"][g], cg["v"][g], pos, acfg, self.cdtype)[0])
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self._logits(params, x), new_cache
