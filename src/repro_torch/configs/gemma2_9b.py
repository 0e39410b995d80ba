"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="decoder",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,                # per hf config (d_model / n_heads would be 224)
    rope_theta=10_000.0,
    local_global_every=2,        # alternate: even layers local (SWA), odd global
    window=4096,                 # local-layer sliding window
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embed=True,
    tie_embeddings=True,
)
