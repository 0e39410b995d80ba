"""Config system: model architecture + input shape + parallelism plan
(restated from ``repro.configs.base``, which uses no framework; the tests
hold the two equal field for field).

Every assigned architecture is a :class:`ModelConfig` instance in its own
module under ``repro_torch.configs``; the registry in
``repro_torch.configs.registry`` maps ``--arch <id>`` to it.  Shapes are
:class:`ShapeConfig` instances — the four assigned shape cells are declared
here once and reused by every arch (each arch filters out inapplicable
cells via :func:`cells_for`).

Nothing in this package touches device state at import time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "ParallelConfig",
    "SHAPES",
    "cells_for",
    "round_up",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description covering all assigned families.

    family: "decoder" | "moe" | "encdec" | "vlm" | "ssm" | "hybrid"
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None          # default: d_model // n_heads
    # Attention flavour ------------------------------------------------------
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0              # chatglm3 "2d RoPE": rotary on half dims
    window: Optional[int] = None            # sliding-window size (SWA)
    local_global_every: Optional[int] = None  # gemma2: 1 == alternate local/global
    attn_logit_softcap: Optional[float] = None   # gemma2
    final_logit_softcap: Optional[float] = None  # gemma2
    qk_norm: bool = False                   # qwen3-style per-head q/k RMSNorm
    sandwich_norm: bool = False             # gemma2: post-norms after attn/mlp
    scale_embed: bool = False               # gemma2: embed * sqrt(d_model)
    # MoE --------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    # SSM (mamba2 / hybrid) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_dim: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0                     # hybrid: shared attn block every k layers
    # Enc-dec ----------------------------------------------------------------
    n_encoder_layers: int = 0
    # VLM --------------------------------------------------------------------
    n_patches: int = 0                      # stub frontend: precomputed patch embeds
    frontend_dim: int = 0                   # raw frame/patch embedding dim
    # Embedding / head -------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # Numerics ---------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Implementation switches ------------------------------------------------
    use_pallas: bool = False                # kept for parity; read by nothing
    remat: bool = True
    moe_bulk_steal: bool = True             # the paper's technique in MoE dispatch
    moe_impl: str = "gspmd"                 # "gspmd" | "ep_shardmap" (§Perf)
    decode_impl: str = "gspmd"              # "gspmd" | "flash_shardmap" (§Perf)

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the head/embedding shard over 16-way TP (and the
        logits shard) always divides evenly."""
        return round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:               # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (sub-quadratic decode memory)."""
        if self.family in ("ssm", "hybrid"):
            return True
        # SWA / alternating-local archs have window-bounded caches on local
        # layers; gemma2's global layers use sequence-sharded KV (SP).
        return self.window is not None or self.local_global_every is not None

    @property
    def has_decode(self) -> bool:
        return True  # no encoder-only arch in the assigned set

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        hd, H, K = self.hd, self.n_heads, self.n_kv_heads
        attn = (D * H * hd + 2 * D * K * hd + H * hd * D) if H else 0
        mlp = 3 * D * F if F else 0
        moe = 0
        if self.n_experts:
            moe = D * self.n_experts + self.n_experts * 3 * D * self.d_ff_expert
            mlp = 0
        ssm = 0
        if self.ssm_state:
            di, ns, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D,dt_bias
            ssm = D * (2 * di + 2 * ns + nh) + self.ssm_conv_dim * (di + 2 * ns) + di * D + 2 * nh
        per_layer = 2 * D  # norms
        if self.family == "ssm":
            per_layer += ssm
        elif self.family == "hybrid":
            per_layer += ssm
        elif self.family == "moe":
            per_layer += attn + moe
        else:
            per_layer += attn + mlp
        total = self.n_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * D * F + 2 * D  # one shared block
        if self.family == "encdec":
            enc_per = 2 * D + attn + mlp
            dec_per = 3 * D + 2 * attn + mlp  # self + cross attn
            total = self.n_encoder_layers * enc_per + self.n_layers * dec_per
        total += V * D  # embedding
        if not self.tie_embeddings:
            total += D * V
        total += D  # final norm
        return int(total)


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def step_name(self) -> str:
        return {"train": "train_step", "prefill": "prefill_step", "decode": "serve_step"}[self.kind]


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)


def cells_for(model: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells that apply to this arch (long_500k requires
    sub-quadratic decode; skips recorded in DESIGN.md)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not model.is_subquadratic:
            continue
        out.append(s)
    return tuple(out)


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a mesh maps onto parallelism axes.

    data_axes are the DP/FSDP axes (batch + parameter sharding); model_axis
    is TP/EP/SP.  On the multi-pod mesh the "pod" axis joins DP for the
    batch but parameters stay replicated across pods (grads all-reduce over
    DCN once per step).
    """

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    pod_axis: Optional[str] = None          # set on the multi-pod mesh
    fsdp_axis: Optional[str] = "data"       # None => pure DP (replicated params)
    remat: bool = True
    microbatch: int = 0                     # 0 => no gradient accumulation

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ((self.pod_axis,) if self.pod_axis else ()) + self.data_axes
