"""Model zoo: config -> model bundle (port of ``repro.models.zoo``), and
:func:`params_from_numpy`, which carries parameters made by the JAX
package (as numpy arrays) over to the port.

The decoder families (``decoder``, ``moe``, ``vlm``: ``DecoderLM``) and the
SSM families (``ssm``, ``hybrid``); the enc-dec family raises, naming the
ROADMAP item it waits for (A10's rest, with the sharded-model path).
Every bundle has ``init``, ``forward``, ``loss_fn``, ``prefill``,
``decode_step``, ``make_cache`` and ``grow_cache``.  ``input_specs`` is
the JAX package's dry-run machinery and has no counterpart here.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.hybrid import HybridLM, SSMLM
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model", "params_from_numpy"]

def build_model(cfg: ModelConfig) -> Union[DecoderLM, SSMLM, HybridLM]:
    if cfg.family in ("decoder", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec family (models/encdec.py) waits for "
            f"the rest of ROADMAP queue A item 10")
    raise ValueError(f"unknown family {cfg.family!r}")


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """A tree of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``)
    as the same tree of tensors on ``device``, dtypes and bits kept."""
    return tree_map(lambda a: _tensor(a, device), tree)
