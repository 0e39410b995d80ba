"""Models (port of ``repro.models``): the decoder, MoE, VLM, SSM and hybrid
families, for serving and training."""
