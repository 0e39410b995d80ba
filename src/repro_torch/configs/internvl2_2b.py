"""internvl2-2b [vlm] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553 — InternViT frontend + InternLM2 backbone.
[arXiv:2404.16821; hf]

Per the assignment, only the LM BACKBONE is modeled; the vision frontend
is a STUB: ``input_specs()`` provides precomputed patch embeddings
(batch, n_patches, frontend_dim) which a learned projection maps into the
token stream as a prefix.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    n_patches=256,               # one 448x448 tile => 256 patch embeddings
    frontend_dim=1024,           # InternViT-300M output width (stubbed)
)
