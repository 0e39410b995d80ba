"""Model zoo: config -> model bundle (port of ``repro.models.zoo``), and
:func:`params_from_numpy`, which carries parameters made by the JAX
package (as numpy arrays) over to the port.

The decoder family only, for now: the other families raise, naming the
ROADMAP item they wait for.  ``input_specs`` is the JAX package's dry-run
machinery and has no counterpart here.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model", "params_from_numpy"]

_WAITING = {
    "ssm": "the SSM family (models/ssm.py with K7 ssd_scan) is the next "
           "slice (ROADMAP queue A item 10)",
    "hybrid": "the hybrid family waits for models/ssm.py and models/hybrid.py "
              "(ROADMAP queue A item 10)",
    "encdec": "the enc-dec family (models/encdec.py) waits for ROADMAP "
              "queue A item 10",
}


def build_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.family in ("decoder", "moe", "vlm"):
        return DecoderLM(cfg)  # which raises for MoE layers and the VLM prefix
    if cfg.family in _WAITING:
        raise NotImplementedError(f"{cfg.name}: {_WAITING[cfg.family]}")
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
