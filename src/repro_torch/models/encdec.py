"""Encoder-decoder backbone, seamless-m4t-medium (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the JAX package: the inputs are
precomputed frame embeddings ``(B, S_enc, frontend_dim)``, which a learned
projection maps to ``d_model``.  The backbone is a pre-norm transformer:
a bidirectional encoder (self-attention with RoPE, no mask) and a causal
decoder whose every layer also cross-attends to the encoder's output (no
RoPE, no mask).  All three attentions of a prefill or a training forward
are one K6 call each (``models.attention.attention``); under ``cfg.remat``
each layer runs under ``torch.utils.checkpoint``, as the JAX package wraps
it in ``jax.checkpoint``.  Stacked ``(L, ...)`` parameters keep the JAX
package's layout, so its weights carry over unchanged; the port loops
over the layers in Python where the JAX package scans them.

Decode: the self-attention cache grows one position a step and is written
in place (``decode_attention``); the cross-attention K / V are computed
once by the prefill from the encoder output and stay fixed, and a decode
step reads them with the JAX package's plain einsum and softmax (no
Pallas kernel there either).

In the sharded step (``with mesh.spmd():``) every function takes this
rank's blocks by ``param_specs`` / ``cache_specs`` (``cache_block``; a
sharded prefill returns its caches so): each layer's FSDP entries are
gathered inside its rematerialised layer, the three attentions split
their heads over ``tp`` and decode through
``attention.decode_attention_sharded`` (the cross-attention cache read,
never written).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch

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

Pytree = Any

__all__ = ["EncDecLM"]

_LOSS_CHUNK = 512


class EncDecLM:
    """Functional model bundle for one enc-dec config."""

    def __init__(self, cfg: ModelConfig, sh: Optional[ShardPlan] = None):
        self.cfg = cfg
        self.sh = sh or ShardPlan()
        self.dtype = getattr(torch, cfg.param_dtype)
        self.cdtype = getattr(torch, cfg.compute_dtype)

    def _acfg(self, causal: bool, rope: bool = True) -> AttnConfig:
        cfg = self.cfg
        return AttnConfig(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta,
            rope_fraction=cfg.rope_fraction if rope else 0.0,
            window=None, softcap=None, qk_norm=False, causal=causal)

    # ------------------------------------------------------------------ init

    def init(self, gen: torch.Generator) -> Pytree:
        """Random parameters on the generator's device (normal x 0.02,
        norms at one)."""
        cfg, dev = self.cfg, gen.device
        D, Vp = cfg.d_model, cfg.padded_vocab
        Le, Ld = cfg.n_encoder_layers, cfg.n_layers

        def ones(*shape):
            return torch.ones(shape, dtype=self.dtype, device=dev)

        enc = {"ln1": ones(Le, D), "ln2": ones(Le, D),
               "attn": attn_init(gen, Le, D, self._acfg(False), self.dtype),
               "mlp": mlp_init(gen, Le, D, cfg.d_ff, self.dtype)}
        dec = {"ln1": ones(Ld, D), "ln_x": ones(Ld, D), "ln2": ones(Ld, D),
               "attn": attn_init(gen, Ld, D, self._acfg(True), self.dtype),
               "xattn": attn_init(gen, Ld, D, self._acfg(False), self.dtype),
               "mlp": mlp_init(gen, Ld, D, cfg.d_ff, self.dtype)}
        return {
            "frontend_proj": dense_init(gen, (cfg.frontend_dim, D),
                                        self.dtype),
            "encoder": enc,
            "enc_norm": ones(D),
            "decoder": dec,
            "embed": embed_init(gen, Vp, D, self.dtype),
            "final_norm": ones(D),
            "lm_head": dense_init(gen, (D, Vp), self.dtype),
        }

    def param_specs(self) -> Pytree:
        """The JAX package's GSPMD layout of ``init``'s tree."""
        tp, fs = self.sh.tp, self.sh.fsdp

        def attn():
            return {"wq": P(None, fs, tp), "wk": P(None, fs, tp),
                    "wv": P(None, fs, tp), "wo": P(None, tp, fs)}

        def mlp():
            return {"w_gate": P(None, fs, tp), "w_up": P(None, fs, tp),
                    "w_down": P(None, tp, fs)}

        return {
            "frontend_proj": P(None, fs),
            "encoder": {"ln1": P(None, None), "ln2": P(None, None),
                        "attn": attn(), "mlp": mlp()},
            "enc_norm": P(None),
            "decoder": {"ln1": P(None, None), "ln_x": P(None, None),
                        "ln2": P(None, None), "attn": attn(),
                        "xattn": attn(), "mlp": mlp()},
            "embed": P(tp, fs),
            "final_norm": P(None),
            "lm_head": P(fs, tp),
        }

    def _pspecs(self) -> Pytree:
        if not hasattr(self, "_spec_cache"):
            self._spec_cache = self.param_specs()
        return self._spec_cache

    def _layer(self, params, stack: str, i: int) -> Pytree:
        """Layer ``i`` of ``params[stack]`` (FSDP-gathered in the sharded
        step)."""
        return fsdp_gather(tree_map(lambda a: a[i], params[stack]),
                           layer_specs(self._pspecs()[stack]), self.sh)

    def _whole(self, params, name: str):
        return fsdp_gather(params[name], self._pspecs()[name], self.sh)

    # --------------------------------------------------------------- encoder

    def _enc_layer(self, x, params, i):
        pl = self._layer(params, "encoder", i)
        eps, acfg = self.cfg.norm_eps, self._acfg(False)
        x = x + attention(pl["attn"], rms_norm(x, pl["ln1"], eps), acfg,
                          self.cdtype, sh=self.sh)
        return x + mlp_apply(pl["mlp"], rms_norm(x, pl["ln2"], eps),
                             self.cdtype, self.sh)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, frontend_dim) frames -> (B, S_enc, D), after the
        encoder's final norm; bidirectional attention through K6."""
        x = frames.to(self.cdtype) @ self._whole(
            params, "frontend_proj").to(self.cdtype)
        for i in range(self.cfg.n_encoder_layers):
            x = remat_call(self._enc_layer, x, params, i,
                           enabled=self.cfg.remat)
        return rms_norm(x, params["enc_norm"], self.cfg.norm_eps)

    # --------------------------------------------------------------- decoder

    def _dec_layer(self, x, params, i, enc_out, kvs=None):
        """Decoder layer ``i``: causal self-attention, cross-attention over
        ``enc_out``, MLP; with ``kvs`` (a list) the self and cross K / V
        are appended to it."""
        pl = self._layer(params, "decoder", i)
        eps, cd, sh = self.cfg.norm_eps, self.cdtype, self.sh
        self_cfg, x_cfg = self._acfg(True), self._acfg(False, rope=False)
        want = kvs is not None
        a = attention(pl["attn"], rms_norm(x, pl["ln1"], eps), self_cfg, cd,
                      return_kv=want, sh=sh)
        if want:
            a, self_kv = a
        x = x + a
        a = attention(pl["xattn"], rms_norm(x, pl["ln_x"], eps), x_cfg, cd,
                      kv_x=enc_out, return_kv=want, sh=sh)
        if want:
            a, cross_kv = a
            kvs.append((self_kv, cross_kv))
        x = x + a
        return x + mlp_apply(pl["mlp"], rms_norm(x, pl["ln2"], eps), cd, sh)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self._whole(params, "embed"), tokens,
                            self.sh).to(self.cdtype)

    def _decoder_forward(self, params, tokens: torch.Tensor,
                         enc_out: torch.Tensor) -> torch.Tensor:
        x = self._embed(params, tokens)
        for i in range(self.cfg.n_layers):
            x = remat_call(self._dec_layer, x, params, i, enc_out,
                           enabled=self.cfg.remat)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    # ------------------------------------------------------------------ loss

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean token cross-entropy of ``batch``: frames (B, S_enc, F),
        tokens and labels (B, S), optional loss_mask; the LM head in
        sequence chunks."""
        enc_out = self.encode(params, batch["frames"])
        hidden = self._decoder_forward(params, batch["tokens"], enc_out)
        return chunked_ce_loss(hidden, self._whole(params, "lm_head").to(
            self.cdtype), batch["labels"], batch.get("loss_mask"),
            chunk=_LOSS_CHUNK, remat=self.cfg.remat, sh=self.sh,
            vocab=self.cfg.padded_vocab)

    # --------------------------------------------------------------- serving

    def make_cache(self, batch: int, seq_len: int, enc_len: int,
                   device=None) -> Pytree:
        """Zeroed self- and cross-attention caches + position, on
        ``device`` (default CUDA; raises without it)."""
        cfg, device = self.cfg, resolve_device(device)
        Ld, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd

        def zeros(length):
            return torch.zeros((Ld, batch, length, K, hd), dtype=self.cdtype,
                               device=device)

        return {"pos": 0,
                "self": {"k": zeros(seq_len), "v": zeros(seq_len)},
                "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}

    def cache_specs(self, seq_len: int, batch: int = 0) -> Pytree:
        """The JAX package's GSPMD layout of the cache."""
        sh = self.sh
        if 0 < batch < 16:
            kv = P(None, None, tuple(sh.dp) + (sh.tp,), None, None)
        elif seq_len >= 8192:
            kv = P(None, sh.dp, sh.tp, None, None)
        else:
            kv = P(None, sh.dp, None, None, None)
        return {"pos": P(), "self": {"k": kv, "v": kv},
                "cross": {"k": kv, "v": kv}}

    def cache_block(self, cache, mesh) -> Pytree:
        """This rank's block of a whole cache by ``cache_specs`` (the
        self-attention length and the batch read from the cache), each
        part's global length recorded as ``seq_len``."""
        sc = cache["self"]
        spec = self.cache_specs(sc["k"].shape[2], sc["k"].shape[1])
        return {"pos": cache["pos"],
                "self": cache_group_block(sc, spec["self"]["k"], mesh),
                "cross": cache_group_block(cache["cross"],
                                           spec["cross"]["k"], mesh)}

    def grow_cache(self, cache: Pytree, target_len: int) -> Pytree:
        """The self-attention cache zero-padded to ``target_len``
        positions; the cross-attention cache is fixed."""
        sc = cache["self"]
        C = sc["k"].shape[2]
        if C >= target_len:
            return cache

        def pad(x):
            out = x.new_zeros(x.shape[:2] + (target_len,) + x.shape[3:])
            out[:, :, :C] = x
            return out

        return {"pos": cache["pos"], "cross": cache["cross"],
                "self": {"k": pad(sc["k"]), "v": pad(sc["v"])}}

    @torch.no_grad()
    def prefill(self, params, frames: torch.Tensor, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
        """Encode the source, run the decoder over the target prefix and
        build both caches; returns (last-position logits (B, 1, V)
        float32, cache)."""
        enc_out = self.encode(params, frames)
        S = tokens.shape[1]
        x = self._embed(params, tokens)
        kvs: list = []
        for i in range(self.cfg.n_layers):
            x = self._dec_layer(x, params, i, enc_out, kvs)
        cache = {"pos": S}
        spec = None
        if _spmd_mesh() is not None:    # the blocks by cache_specs
            B = x.shape[0] * _spmd_mesh().size(batch_entry(self.sh))
            spec = self.cache_specs(S, B)["self"]["k"]
        for j, part in enumerate(("self", "cross")):
            cache[part] = {
                "k": torch.stack([kv[j][0] for kv in kvs]).to(self.cdtype),
                "v": torch.stack([kv[j][1] for kv in kvs]).to(self.cdtype)}
            if spec is not None:
                length = cache[part]["k"].shape[2]
                cache[part] = {kv: kv_to_layout(t, spec, self.sh)
                               for kv, t in cache[part].items()}
                cache[part]["seq_len"] = length
        return self._logits(params, x[:, -1:]), cache

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return gather_logits((x @ self._whole(params, "lm_head").to(
            self.cdtype)).float(), self.sh, self.cfg.padded_vocab)

    def _cross_decode(self, p, h: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor) -> torch.Tensor:
        """One token's cross-attention over the fixed encoder K / V (the
        JAX package's plain einsum and softmax)."""
        cfg, cd = self.cfg, self.cdtype
        B = h.shape[0]
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        qg = (h.to(cd) @ p["wq"].to(cd)).reshape(B, K, H // K, hd)
        logits = torch.einsum("bkgh,btkh->bkgt", qg, ck.to(cd)).float()
        w = torch.softmax(logits / math.sqrt(hd), dim=-1).to(cd)
        o = torch.einsum("bkgt,btkh->bkgh", w, cv.to(cd)).reshape(B, 1,
                                                                  H * hd)
        return o @ p["wo"].to(cd)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Pytree]:
        """One-token decode. tokens: (B, 1). Returns (logits (B, 1, V)
        float32, cache); the self-attention K / V are written into the
        cache in place."""
        eps, cd, sh = self.cfg.norm_eps, self.cdtype, self.sh
        x = self._embed(params, tokens)
        pos = int(cache["pos"])
        self_cfg = self._acfg(True)
        sc, xc = cache["self"], cache["cross"]
        spmd = _spmd_mesh()
        if spmd is not None:
            B = x.shape[0] * spmd.size(batch_entry(sh))
            entry = self.cache_specs(sc["seq_len"], B)["self"]["k"][2]
        for i in range(self.cfg.n_layers):
            pl = self._layer(params, "decoder", i)
            h = rms_norm(x, pl["ln1"], eps)
            if spmd is not None:
                x = x + decode_attention_sharded(
                    pl["attn"], h, sc["k"][i], sc["v"][i], pos, self_cfg,
                    sh, cd, length=sc["seq_len"], seq_entry=entry)
                x = x + decode_attention_sharded(
                    pl["xattn"], rms_norm(x, pl["ln_x"], eps), xc["k"][i],
                    xc["v"][i], pos, self._acfg(False, rope=False), sh, cd,
                    length=xc["seq_len"], seq_entry=entry, cross=True)
            else:
                x = x + decode_attention(pl["attn"], h, sc["k"][i],
                                         sc["v"][i], pos, self_cfg, cd)[0]
                x = x + self._cross_decode(pl["xattn"],
                                           rms_norm(x, pl["ln_x"], eps),
                                           xc["k"][i], xc["v"][i])
            x = x + mlp_apply(pl["mlp"], rms_norm(x, pl["ln2"], eps), cd, sh)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return self._logits(params, x), new_cache
