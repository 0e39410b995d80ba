"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 — GQA. [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="decoder",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,  # granite-3.0-2b ties embeddings
)
