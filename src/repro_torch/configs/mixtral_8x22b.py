"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    window=4096,                 # per assignment: SWA (window bounds the KV cache)
    n_experts=8,
    top_k=2,
    d_ff_expert=16384,
)
