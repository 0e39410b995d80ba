"""Models (port of ``repro.models``): the decoder, MoE, VLM, SSM and hybrid
families, for serving and training."""

from repro_torch.models.zoo import build_model, input_specs

__all__ = ["build_model", "input_specs"]
