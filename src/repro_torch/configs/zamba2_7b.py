"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32, MHA) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention blocks.
[arXiv:2411.15242; unverified]

Zamba2's signature trick: one set of attention+MLP parameters is SHARED
and applied every ``attn_every`` mamba blocks (we use 6, matching the
published ~13 shared-block applications over 81 layers).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,                  # MLP width of the shared block
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_dim=4,
    ssm_chunk=256,
    attn_every=6,
    tie_embeddings=True,
)
