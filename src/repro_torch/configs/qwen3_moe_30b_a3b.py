"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

The assigned d_ff=768 is the per-expert FFN width (Qwen3-MoE's
moe_intermediate_size); every layer is MoE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=0,                      # no dense FFN; all layers MoE
    vocab_size=151936,
    head_dim=128,                # per hf config
    rope_theta=1_000_000.0,
    qk_norm=True,                # qwen3 per-head q/k RMSNorm
    n_experts=128,
    top_k=8,
    d_ff_expert=768,
)
