"""``--arch <id>`` registry + reduced smoke-test variants.

``get(arch_id)`` returns the full assigned config; ``reduced(cfg)`` returns
a small same-family config for CPU smoke tests (full configs are exercised
only via the dry-run's ShapeDtypeStructs, never allocated on CPU).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, cells_for

_MODULES: Dict[str, str] = {
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_IDS = tuple(_MODULES)


def get(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Small same-family variant for CPU smoke tests: few layers, narrow
    width, tiny vocab, few experts — preserves every structural feature
    (GQA ratio, windowing, softcaps, MoE top-k, SSM heads, shared block)."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4 if not cfg.attn_every else 7),
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32 if cfg.n_heads else None,
        tie_embeddings=cfg.tie_embeddings,
    )
    if cfg.n_heads:
        # Preserve the GQA group ratio where possible.
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(4 // min(ratio, 4), 1)
    if cfg.window:
        kw["window"] = 16
    if cfg.n_experts:
        kw["n_experts"] = 8
        kw["top_k"] = min(cfg.top_k, 2)
        kw["d_ff_expert"] = 64
    if cfg.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 16
    if cfg.attn_every:
        kw["attn_every"] = 3
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["n_layers"] = 2
    if cfg.n_patches:
        kw["n_patches"] = 8
        kw["frontend_dim"] = 64
    if cfg.frontend_dim and not cfg.n_patches:
        kw["frontend_dim"] = 64
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCH_IDS", "get", "reduced", "SHAPES", "cells_for", "ShapeConfig"]
