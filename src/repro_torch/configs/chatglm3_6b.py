"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (rotary on half the head dims), GQA.
[arXiv:2406.12793; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="decoder",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10_000.0,
    rope_fraction=0.5,  # GLM "2d" RoPE: rotary applied to half of each head
)
