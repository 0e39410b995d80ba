"""Model zoo: config -> model bundle (port of ``repro.models.zoo``), and
:func:`params_from_numpy`, which carries parameters made by the JAX
package (as numpy arrays) over to the port.

Every family of the JAX package: the decoder families (``decoder``,
``moe``, ``vlm``: ``DecoderLM``), the enc-dec family (``EncDecLM``) and
the SSM families (``ssm``, ``hybrid``).  Every bundle has ``init``,
``loss_fn``, ``prefill``, ``decode_step``, ``make_cache``, ``grow_cache``,
``param_specs`` and ``cache_specs``; ``parallel`` (a
``configs.ParallelConfig``) names the axes of the specs, as in the JAX
package.  ``input_specs`` is the JAX package's dry-run machinery and has
no counterpart here.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM, SSMLM
from repro_torch.models.layers import ShardPlan
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model", "params_from_numpy"]


def build_model(cfg: ModelConfig, parallel: Optional[ParallelConfig] = None
                ) -> Union[DecoderLM, EncDecLM, SSMLM, HybridLM]:
    sh = ShardPlan.from_parallel(parallel) if parallel else ShardPlan()
    if cfg.family in ("decoder", "moe", "vlm"):
        return DecoderLM(cfg, sh)
    if cfg.family == "encdec":
        return EncDecLM(cfg, sh)
    if cfg.family == "ssm":
        return SSMLM(cfg, sh)
    if cfg.family == "hybrid":
        return HybridLM(cfg, sh)
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
