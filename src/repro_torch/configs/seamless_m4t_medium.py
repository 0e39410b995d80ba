"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16, MHA) d_ff=4096
vocab=256206 — encoder-decoder, multimodal. [arXiv:2308.11596; hf]

Per the assignment, the modality frontend is a STUB: ``input_specs()``
provides precomputed audio-frame embeddings of shape (batch, frames,
frontend_dim); the transformer backbone (12L encoder + 12L decoder with
cross-attention) is what this config exercises.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,                 # decoder layers
    n_encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=10_000.0,
    frontend_dim=160,            # stub: 80-dim fbank x2 stacking
)
