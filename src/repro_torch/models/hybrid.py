"""The SSM family: the pure Mamba2 LM (mamba2-2.7b) and the hybrid Mamba2 +
shared-attention LM (zamba2-7b) (port of ``repro.models.hybrid``).

:class:`SSMLM` stacks ``n_layers`` pre-normed Mamba2 blocks.
:class:`HybridLM`'s layer plan for ``n_layers=81, attn_every=6``: 13
groups of 6 Mamba2 blocks, each group followed by ONE application of a
SHARED attention + MLP block (one parameter set reused 13 times), then a
tail of 81 - 78 = 3 Mamba2 blocks.  The shared block's KV caches are per
application (13 of them) although its weights are shared.

Every block's scan in ``forward`` and ``prefill`` runs through K7
(``models.ssm.mamba_block``); the shared block's attention through K6
(``models.attention.attention``); both kernels' CUDA routes have a
gradient (their plain versions').  ``forward`` is differentiable: under
``cfg.remat`` each SSMLM layer, each hybrid group (its six blocks and the
shared block) and each tail layer runs under ``torch.utils.checkpoint``,
as the JAX package wraps them in ``jax.checkpoint``.  ``loss_fn`` is the
chunked LM-head cross-entropy.  Decode is plain PyTorch: the O(1) state
update and ``decode_attention``; like ``DecoderLM.decode_step`` it writes
the new conv inputs, states and K / V into the cache tensors in place.
Parameters keep the JAX package's layout (stacked ``(L, ...)`` leaves,
``(NG, AE, ...)`` for the hybrid's groups), so its weights carry over
unchanged.  The JAX package scans the layers; the port loops over them in
Python.  ``param_specs`` and ``cache_specs`` are the JAX package's GSPMD
layouts (trees of ``layers.P``, equal leaf for leaf).  In the sharded step
(``with mesh.spmd():``) every function takes this rank's blocks by them
(``cache_block`` cuts a whole cache; a sharded prefill returns its cache
so): each layer's FSDP entries are gathered inside its rematerialised
unit, the mixer splits its heads over ``tp`` (``models.ssm``) and the
shared block its attention heads and MLP columns.
"""

from __future__ import annotations

import functools
from typing import Any, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (AttnConfig, attention, attn_init,
                                          decode_attention,
                                          decode_attention_sharded)
from repro_torch.models.layers import (P, ShardPlan, _spmd_mesh,
                                       batch_entry, cache_group_block,
                                       chunked_ce_loss, dense_init,
                                       embed_init, embed_lookup,
                                       fsdp_gather, gather_logits,
                                       kv_to_layout, layer_specs, mlp_apply,
                                       mlp_init, remat_call, rms_norm)
from repro_torch.models.ssm import (SSMCache, SSMConfig, mamba_block,
                                    mamba_decode_step, ssm_init)

Pytree = Any

__all__ = ["HybridLM", "SSMLM"]

_SEQ_SHARD_MIN = 8192       # the shared block's caches shard on seq from here


class _MambaLM:
    """What both SSM models share: config, embedding, head, one residual
    Mamba2 block for prefill and for decode, and the SSM cache."""

    def __init__(self, cfg: ModelConfig, sh: Optional[ShardPlan] = None):
        self.cfg = cfg
        self.sh = sh or ShardPlan()
        self.dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)
        self.scfg = SSMConfig(
            d_model=cfg.d_model, d_inner=cfg.d_inner,
            n_heads=cfg.n_ssm_heads, head_dim=cfg.ssm_head_dim,
            state=cfg.ssm_state, conv_dim=cfg.ssm_conv_dim,
            chunk=cfg.ssm_chunk)

    def _ssm_specs(self, lead: int) -> Pytree:
        """The JAX package's specs of one Mamba2 block's leaves behind
        ``lead`` stacked dims."""
        tp, fs, n = self.sh.tp, self.sh.fsdp, (None,) * lead
        return {
            "w_z": P(*n, fs, tp), "w_x": P(*n, fs, tp),
            "w_B": P(*n, fs, None), "w_C": P(*n, fs, None),
            "w_dt": P(*n, fs, tp),
            "conv_x": P(*n, None, tp), "conv_B": P(*n, None, None),
            "conv_C": P(*n, None, None),
            "A_log": P(*n, tp), "D": P(*n, tp), "dt_bias": P(*n, tp),
            "out_proj": P(*n, tp, fs), "gate_norm": P(*n, tp),
        }

    def _ssm_cache_specs(self, lead: int, batch: int) -> Pytree:
        dp = None if 0 < batch < 16 else self.sh.dp
        n = (None,) * lead
        return {"conv_buf": P(*n, dp, None, None),
                "state": P(*n, dp, self.sh.tp, None, None)}

    def _ones(self, gen: torch.Generator, *shape) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=gen.device)

    def _pspecs(self) -> Pytree:
        if not hasattr(self, "_spec_cache"):
            self._spec_cache = self.param_specs()
        return self._spec_cache

    def _gathered(self, tree, name: str, lead: int) -> Pytree:
        """One layer's ``tree`` of stack ``name`` (``lead`` stacked dims),
        FSDP-gathered in the sharded step."""
        return fsdp_gather(tree, layer_specs(self._pspecs()[name], lead),
                           self.sh)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        table = fsdp_gather(params["embed"], self._pspecs()["embed"],
                            self.sh)
        return embed_lookup(table, tokens, self.sh).to(self.cdtype)

    def _head(self, params) -> torch.Tensor:
        sp = self._pspecs()
        if self.cfg.tie_embeddings:
            return fsdp_gather(params["embed"], sp["embed"], self.sh).T
        return fsdp_gather(params["lm_head"], sp["lm_head"], self.sh)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm -> head -> float32."""
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return gather_logits((x @ self._head(params).to(self.cdtype))
                             .float(), self.sh, self.cfg.padded_vocab)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean token cross-entropy of ``batch`` (tokens, labels, optional
        loss_mask), the LM head in sequence chunks."""
        hidden = self.forward(params, batch["tokens"])
        return chunked_ce_loss(hidden, self._head(params).to(self.cdtype),
                               batch["labels"], batch.get("loss_mask"),
                               remat=self.cfg.remat, sh=self.sh,
                               vocab=self.cfg.padded_vocab)

    def _mamba(self, pl, x: torch.Tensor, capture: bool = False):
        """One residual block, ``pl`` holding ``ln`` and ``ssm``; with
        ``capture`` also its (conv tail, final state)."""
        h = rms_norm(x, pl["ln"], self.cfg.norm_eps)
        if not capture:
            return x + mamba_block(pl["ssm"], h, self.scfg, self.cdtype,
                                   sh=self.sh)
        out, caught = mamba_block(pl["ssm"], h, self.scfg, self.cdtype,
                                  capture=True, sh=self.sh)
        return x + out, caught

    def _mamba_at(self, params, name: str, index, x: torch.Tensor):
        """:meth:`_mamba` of layer ``index`` of stack ``name``, its
        parameters taken (and gathered) here: inside a rematerialised
        call they are gathered again in the backward."""
        lead = 1 if isinstance(index, int) else len(index)
        pl = self._gathered(tree_map(lambda a: a[index], params[name]),
                            name, lead)
        return self._mamba(pl, x)

    @staticmethod
    def _stack_caught(caught, lead) -> Pytree:
        """The decode cache of blocks run with ``capture``: their (conv
        tail, final state) pairs stacked on the leading dims ``lead``."""
        return {name: torch.stack(parts).reshape(lead + parts[0].shape)
                for name, parts in zip(("conv_buf", "state"), zip(*caught))}

    def _mamba_step(self, pl, x: torch.Tensor, conv_buf: torch.Tensor,
                    state: torch.Tensor) -> torch.Tensor:
        """One residual decode step; ``conv_buf`` and ``state`` (one
        layer's cache) are updated in place."""
        h = rms_norm(x, pl["ln"], self.cfg.norm_eps)
        out, new = mamba_decode_step(pl["ssm"], h, SSMCache(conv_buf, state),
                                     self.scfg, self.cdtype, self.sh)
        conv_buf.copy_(new.conv_buf)
        state.copy_(new.state)
        return x + out

    def _ssm_cache(self, lead, batch: int, device) -> Pytree:
        cfg = self.cfg
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        return {
            "conv_buf": torch.zeros(lead + (batch, cfg.ssm_conv_dim - 1,
                                            conv_ch),
                                    dtype=self.cdtype, device=device),
            "state": torch.zeros(lead + (batch, cfg.n_ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# Pure SSM LM (mamba2)
# ---------------------------------------------------------------------------


class SSMLM(_MambaLM):
    """Functional model bundle for one pure-SSM config."""

    def param_specs(self) -> Pytree:
        """The JAX package's GSPMD layout of ``init``'s tree."""
        tp, fs = self.sh.tp, self.sh.fsdp
        specs = {"embed": P(tp, fs),
                 "layers": {"ln": P(None, None), "ssm": self._ssm_specs(1)},
                 "final_norm": P(None)}
        if not self.cfg.tie_embeddings:
            specs["lm_head"] = P(fs, tp)
        return specs

    def cache_specs(self, seq_len: int, batch: int = 0) -> Pytree:
        """The JAX package's GSPMD layout of the cache."""
        return {"pos": P(), "ssm": self._ssm_cache_specs(1, batch)}

    def init(self, gen: torch.Generator) -> Pytree:
        """Random parameters on the generator's device."""
        cfg = self.cfg
        L, D = cfg.n_layers, cfg.d_model
        params = {
            "embed": embed_init(gen, cfg.padded_vocab, D, self.dtype),
            "layers": {"ln": self._ones(gen, L, D),
                       "ssm": ssm_init(gen, L, self.scfg, self.dtype)},
            "final_norm": self._ones(gen, D),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (D, cfg.padded_vocab),
                                           self.dtype)
        return params

    def _layers(self, params) -> Iterator[Tuple[int, Pytree]]:
        for l in range(self.cfg.n_layers):
            yield l, self._gathered(tree_map(lambda a: a[l],
                                             params["layers"]), "layers", 1)

    def cache_block(self, cache, mesh) -> Pytree:
        """This rank's block of a whole cache by ``cache_specs``."""
        B = cache["ssm"]["state"].shape[1]
        return mesh.shard(cache, self.cache_specs(0, B))

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) hidden (after final norm);
        differentiable, each layer rematerialized under ``cfg.remat``."""
        x = self._embed(params, tokens)
        for l in range(self.cfg.n_layers):
            x = remat_call(self._mamba_at, params, "layers", l, x,
                           enabled=self.cfg.remat)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def make_cache(self, batch: int, seq_len: int, device=None) -> Pytree:
        """Zeroed conv buffers and states, + position, on ``device``
        (default CUDA; raises without it).  ``seq_len`` is unused: the
        cache is O(1) in it."""
        device = resolve_device(device)
        return {"pos": 0,
                "ssm": self._ssm_cache((self.cfg.n_layers,), batch, device)}

    def grow_cache(self, cache: Pytree, target_len: int) -> Pytree:
        """Pure-SSM cache is O(1); nothing grows."""
        return cache

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
        """Forward over the prompt; returns (last-position logits (B,1,V)
        float32, cache with every layer's conv tail and final state)."""
        x = self._embed(params, tokens)
        caught = []
        for _, pl in self._layers(params):
            x, c = self._mamba(pl, x, capture=True)
            caught.append(c)
        cache = {"pos": tokens.shape[1],
                 "ssm": self._stack_caught(caught, (self.cfg.n_layers,))}
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Pytree]:
        """One-token decode. tokens: (B, 1). Returns (logits (B,1,V)
        float32, cache); the cache's tensors are updated in place."""
        x = self._embed(params, tokens)
        c = cache["ssm"]
        for l, pl in self._layers(params):
            x = self._mamba_step(pl, x, c["conv_buf"][l], c["state"][l])
        return self._logits(params, x), {"pos": cache["pos"] + 1, "ssm": c}


# ---------------------------------------------------------------------------
# Hybrid: Mamba2 groups + one shared attention block (zamba2)
# ---------------------------------------------------------------------------


class HybridLM(_MambaLM):
    """Functional model bundle for one hybrid config."""

    def __init__(self, cfg: ModelConfig, sh: Optional[ShardPlan] = None):
        super().__init__(cfg, sh)
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.tail = cfg.n_layers - self.n_groups * cfg.attn_every
        self.acfg = AttnConfig(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            window=None, softcap=None, qk_norm=False, causal=True)

    def init(self, gen: torch.Generator) -> Pytree:
        """Random parameters on the generator's device."""
        cfg = self.cfg
        NG, AE, D = self.n_groups, cfg.attn_every, cfg.d_model
        ssm = ssm_init(gen, NG * AE, self.scfg, self.dtype)
        params = {
            "embed": embed_init(gen, cfg.padded_vocab, D, self.dtype),
            "grouped": {
                "ln": self._ones(gen, NG, AE, D),
                "ssm": tree_map(lambda a: a.reshape((NG, AE) + a.shape[1:]),
                                ssm)},
            "shared": {
                "ln1": self._ones(gen, D),
                "ln2": self._ones(gen, D),
                "attn": tree_map(lambda a: a[0], attn_init(
                    gen, 1, D, self.acfg, self.dtype)),
                "mlp": tree_map(lambda a: a[0], mlp_init(
                    gen, 1, D, cfg.d_ff, self.dtype))},
            "final_norm": self._ones(gen, D),
        }
        if self.tail:
            params["tail"] = {
                "ln": self._ones(gen, self.tail, D),
                "ssm": ssm_init(gen, self.tail, self.scfg, self.dtype)}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (D, cfg.padded_vocab),
                                           self.dtype)
        return params

    def _group(self, params, g: int) -> Iterator[Tuple[int, Pytree]]:
        for l in range(self.cfg.attn_every):
            yield l, self._gathered(tree_map(lambda a: a[g, l],
                                             params["grouped"]),
                                    "grouped", 2)

    def _tail(self, params) -> Iterator[Tuple[int, Pytree]]:
        for l in range(self.tail):
            yield l, self._gathered(tree_map(lambda a: a[l],
                                             params["tail"]), "tail", 1)

    def _shared_block(self, params, x: torch.Tensor, attn_fn) -> torch.Tensor:
        """The shared attention (``attn_fn(params, normed x)``) and MLP,
        each pre-normed on the residual."""
        s = fsdp_gather(params["shared"], self._pspecs()["shared"], self.sh)
        eps = self.cfg.norm_eps
        x = x + attn_fn(s["attn"], rms_norm(x, s["ln1"], eps))
        return x + mlp_apply(s["mlp"], rms_norm(x, s["ln2"], eps),
                             self.cdtype, self.sh)

    def _group_fn(self, params, g: int, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
        """Group ``g``'s Mamba2 blocks, then the shared block."""
        for _, pl in self._group(params, g):
            x = self._mamba(pl, x)
        return self._shared_block(params, x, lambda p, h: attention(
            p, h, self.acfg, self.cdtype, positions=positions, sh=self.sh))

    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens -> (B, S, D) hidden (after final norm);
        differentiable, each group and each tail layer rematerialized
        under ``cfg.remat``."""
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        remat = self.cfg.remat
        for g in range(self.n_groups):
            x = remat_call(self._group_fn, params, g, x, positions,
                           enabled=remat)
        for l in range(self.tail):
            x = remat_call(self._mamba_at, params, "tail", l, x,
                           enabled=remat)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def param_specs(self) -> Pytree:
        """The JAX package's GSPMD layout of ``init``'s tree."""
        tp, fs = self.sh.tp, self.sh.fsdp
        specs = {
            "embed": P(tp, fs),
            "grouped": {"ln": P(None, None, None), "ssm": self._ssm_specs(2)},
            "shared": {
                "ln1": P(None), "ln2": P(None),
                "attn": {"wq": P(fs, tp), "wk": P(fs, tp),
                         "wv": P(fs, tp), "wo": P(tp, fs)},
                "mlp": {"w_gate": P(fs, tp), "w_up": P(fs, tp),
                        "w_down": P(tp, fs)},
            },
            "final_norm": P(None),
        }
        if self.tail:
            specs["tail"] = {"ln": P(None, None), "ssm": self._ssm_specs(1)}
        if not self.cfg.tie_embeddings:
            specs["lm_head"] = P(fs, tp)
        return specs

    def cache_specs(self, seq_len: int, batch: int = 0) -> Pytree:
        """The JAX package's GSPMD layout of the cache."""
        sh = self.sh
        if 0 < batch < 16:
            kv = P(None, None, tuple(sh.dp) + (sh.tp,), None, None)
        elif seq_len >= _SEQ_SHARD_MIN:
            kv = P(None, sh.dp, sh.tp, None, None)
        else:
            kv = P(None, sh.dp, None, None, None)
        specs = {"pos": P(),
                 "grouped_ssm": self._ssm_cache_specs(2, batch),
                 "shared_attn": {"k": kv, "v": kv}}
        if self.tail:
            specs["tail_ssm"] = self._ssm_cache_specs(1, batch)
        return specs

    def cache_block(self, cache, mesh) -> Pytree:
        """This rank's block of a whole cache by ``cache_specs`` (its
        length and batch read from the cache), the shared attention's
        global length recorded as ``seq_len``."""
        sa = cache["shared_attn"]
        specs = self.cache_specs(sa["k"].shape[2], sa["k"].shape[1])
        out = mesh.shard({k: v for k, v in cache.items()
                          if k != "shared_attn"},
                         {k: v for k, v in specs.items()
                          if k != "shared_attn"})
        out["shared_attn"] = cache_group_block(
            sa, specs["shared_attn"]["k"], mesh)
        return out

    def _kv_spec(self, length: int, rows: int) -> P:
        m = _spmd_mesh()
        B = rows * m.size(batch_entry(self.sh))
        return self.cache_specs(length, B)["shared_attn"]["k"]

    def make_cache(self, batch: int, seq_len: int, device=None) -> Pytree:
        """Zeroed SSM caches, per-application shared-attention KV caches
        of ``seq_len``, + position, on ``device`` (default CUDA; raises
        without it)."""
        cfg, device = self.cfg, resolve_device(device)
        kv = (self.n_groups, batch, seq_len, cfg.n_kv_heads, cfg.hd)
        cache = {
            "pos": 0,
            "grouped_ssm": self._ssm_cache((self.n_groups, cfg.attn_every),
                                           batch, device),
            "shared_attn": {
                "k": torch.zeros(kv, dtype=self.cdtype, device=device),
                "v": torch.zeros(kv, dtype=self.cdtype, device=device)},
        }
        if self.tail:
            cache["tail_ssm"] = self._ssm_cache((self.tail,), batch, device)
        return cache

    def grow_cache(self, cache: Pytree, target_len: int) -> Pytree:
        """Shared-attention caches are linear: zero-pad; SSM state is
        O(1)."""
        sa = cache["shared_attn"]
        C = sa["k"].shape[2]
        if C >= target_len:
            return cache
        out = dict(cache)
        out["shared_attn"] = {
            kv: F.pad(sa[kv], (0, 0, 0, 0, 0, target_len - C))
            for kv in ("k", "v")}
        return out

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
        """Forward over the prompt; returns (last-position logits (B,1,V)
        float32, cache)."""
        x = self._embed(params, tokens)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        caught, ks, vs = [], [], []

        def attn_fn(p, h):
            a, (k, v) = attention(p, h, self.acfg, self.cdtype,
                                  positions=positions, return_kv=True,
                                  sh=self.sh)
            ks.append(k.to(self.cdtype))
            vs.append(v.to(self.cdtype))
            return a

        for g in range(self.n_groups):
            for _, pl in self._group(params, g):
                x, c = self._mamba(pl, x, capture=True)
                caught.append(c)
            x = self._shared_block(params, x, attn_fn)
        cache = {
            "pos": S,
            "grouped_ssm": self._stack_caught(
                caught, (self.n_groups, self.cfg.attn_every)),
            "shared_attn": {"k": torch.stack(ks), "v": torch.stack(vs)},
        }
        if _spmd_mesh() is not None:    # this rank's block by cache_specs
            spec = self._kv_spec(S, x.shape[0])
            cache["shared_attn"] = {
                kv: kv_to_layout(t, spec, self.sh)
                for kv, t in cache["shared_attn"].items()}
            cache["shared_attn"]["seq_len"] = S
        if self.tail:
            caught = []
            for _, pl in self._tail(params):
                x, c = self._mamba(pl, x, capture=True)
                caught.append(c)
            cache["tail_ssm"] = self._stack_caught(caught, (self.tail,))
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Pytree]:
        """One-token decode. tokens: (B, 1). Returns (logits (B,1,V)
        float32, cache); the cache's tensors are updated in place."""
        x = self._embed(params, tokens)
        pos = int(cache["pos"])
        gs, sa = cache["grouped_ssm"], cache["shared_attn"]
        for g in range(self.n_groups):
            for l, pl in self._group(params, g):
                x = self._mamba_step(pl, x, gs["conv_buf"][g, l],
                                     gs["state"][g, l])
            x = self._shared_block(params, x, functools.partial(
                self._decode_attn, sa=sa, g=g, pos=pos))
        if self.tail:
            ts = cache["tail_ssm"]
            for l, pl in self._tail(params):
                x = self._mamba_step(pl, x, ts["conv_buf"][l],
                                     ts["state"][l])
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self._logits(params, x), new_cache

    def _decode_attn(self, p, h, *, sa, g, pos):
        """The shared block's decode attention of application ``g``: in
        the sharded step against the cache's ``cache_specs`` layout."""
        if _spmd_mesh() is not None:
            spec = self._kv_spec(sa["seq_len"], h.shape[0])
            return decode_attention_sharded(
                p, h, sa["k"][g], sa["v"][g], pos, self.acfg, self.sh,
                self.cdtype, length=sa["seq_len"], seq_entry=spec[2])
        return decode_attention(p, h, sa["k"][g], sa["v"][g], pos,
                                self.acfg, self.cdtype)[0]
