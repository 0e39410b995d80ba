"""Model zoo: config -> model bundle (port of ``repro.models.zoo``), and
:func:`params_from_numpy`, which carries parameters made by the JAX
package (as numpy arrays) over to the port.

Every family of the JAX package: the decoder families (``decoder``,
``moe``, ``vlm``: ``DecoderLM``), the enc-dec family (``EncDecLM``) and
the SSM families (``ssm``, ``hybrid``).  Every bundle has ``init``,
``loss_fn``, ``prefill``, ``decode_step``, ``make_cache``, ``grow_cache``,
``param_specs`` and ``cache_specs``; ``parallel`` (a
``configs.ParallelConfig``) names the axes of the specs, as in the JAX
package.

``input_specs(cfg, shape, parallel)`` returns a shape cell's batch as
``TensorSpec`` stand-ins (``torch.Size`` and dtype, never allocated) and
the matching tree of ``layers.P`` (the JAX package's, entry for entry);
``meta_init`` makes a model's parameters on ``meta`` (shapes and dtypes
only) for the dry run.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM, SSMLM
from repro_torch.models.layers import P, ShardPlan
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model", "params_from_numpy", "input_specs", "batch_specs",
           "TensorSpec", "meta_init"]


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


# ---------------------------------------------------------------------------
# input specs per shape cell (stand-ins, no allocation)


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: torch.Size
    dtype: torch.dtype


def _ts(shape, dtype) -> TensorSpec:
    return TensorSpec(torch.Size(shape), dtype)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                parallel: Optional[ParallelConfig] = None
                ) -> Tuple[Dict[str, TensorSpec], Dict[str, P]]:
    """Returns (batch specs, batch partition specs) for the (arch, shape)
    cell, as the JAX package's ``input_specs``:

    train:   tokens / labels (B, S) [+ patches / frames per family]
    prefill: tokens (B, S) [+ patches / frames]
    decode:  tokens (B, 1); the caches come from the model's
             ``make_cache`` / ``cache_specs``.
    """
    B, S = shape.global_batch, shape.seq_len
    dp = parallel.batch_axes if parallel else ("data",)
    i32, f32 = torch.int32, torch.float32

    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        if cfg.family == "vlm":
            S_text = S - cfg.n_patches
            sds = {"tokens": _ts((B, S_text), i32)}
            ps = {"tokens": P(dp, None)}
            if train:
                sds["labels"], ps["labels"] = _ts((B, S_text), i32), \
                    P(dp, None)
            sds["patches"] = _ts((B, cfg.n_patches, cfg.frontend_dim), f32)
            ps["patches"] = P(dp, None, None)
        elif cfg.family == "encdec":
            sds = {"frames": _ts((B, S, cfg.frontend_dim), f32),
                   "tokens": _ts((B, S), i32)}
            ps = {"frames": P(dp, None, None), "tokens": P(dp, None)}
            if train:
                sds["labels"], ps["labels"] = _ts((B, S), i32), P(dp, None)
        else:
            sds = {"tokens": _ts((B, S), i32)}
            ps = {"tokens": P(dp, None)}
            if train:
                sds["labels"], ps["labels"] = _ts((B, S), i32), P(dp, None)
        return sds, ps

    # decode: one new token against a seq_len cache.  A batch of 1
    # (long_500k) cannot shard over the batch axes: replicate it.
    sds = {"tokens": _ts((B, 1), i32)}
    ps = {"tokens": P(dp, None) if B >= 16 else P(None, None)}
    return sds, ps


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                parallel: Optional[ParallelConfig] = None):
    """Alias of :func:`input_specs` (the JAX package keeps it for its
    benchmark harness)."""
    return input_specs(cfg, shape, parallel)


class _OnMeta(TorchFunctionMode):
    """Every factory call (a ``device=`` keyword) made on ``meta``, its
    generator dropped."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def meta_init(model) -> Any:
    """``model.init``'s tree on ``meta``: every leaf's shape and dtype, no
    storage (the dry run's parameters)."""
    with _OnMeta():
        return model.init(torch.Generator())
