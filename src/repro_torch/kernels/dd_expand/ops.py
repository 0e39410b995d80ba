"""Wrappers of K5 ``dd_expand`` and of the fused DD explore built on it.

``expand_pool(states, values, w, p)`` expands ``(..., W)`` int32 node
pools into ``(..., 2W)`` children, each row ``[0-arcs | 1-arcs]`` — the
layout of ``core/dd/diagram.expand_layer``, which calls it.
``expand_layer_bulk`` is the JAX package's reach (``(N,)`` nodes to
``(2N,)`` children).  ``w`` and ``p`` are Python ints or one-element
int32 tensors; on the card the kernel reads a tensor's value where it
lies, so the host never waits for it.  For a CUDA tensor the CUDA kernel
(``expand.cu``) runs, for a CPU tensor the plain version
(``ref.expand_ref``).  There is no other route: a CUDA tensor the kernel
does not take raises.

``explore_fused`` is K5's redesign for the solver (``explore.cu``): the
restricted DD, the relaxed DD and the exact frontier of a batch of
subproblems over every layer, in one launch.  It takes CUDA tensors only:
``core/dd/bnb.explore_batch`` calls it for those and runs its plain
version, ``bnb.explore_batch_plain``, for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.dd_expand.ref import expand_ref

__all__ = ["expand_pool", "expand_layer_bulk", "explore_fused"]


def _scalar(x, dev: torch.device, name: str):
    """``(device pointer or None, value)`` of the arc weight or profit."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32 or x.numel() != 1 or x.device != dev:
            raise ValueError(f"{name} must be one int32 element on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        return x.data_ptr(), 0
    x = int(x)
    if not -2 ** 31 <= x < 2 ** 31:
        raise ValueError(f"{name} = {x} does not fit int32")
    return None, x


def expand_pool(states: torch.Tensor, values: torch.Tensor, w, p
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both arcs of every node; ``expand_pool.launches`` counts the CUDA
    launches."""
    if states.device.type == "cpu":
        return expand_ref(states, values, w, p)
    dev = _lib.check_cuda(states, values)
    if states.dtype != torch.int32 or values.dtype != torch.int32:
        raise ValueError(f"states and values must be int32, got "
                         f"{states.dtype} and {values.dtype}")
    if states.shape != values.shape or states.ndim == 0:
        raise ValueError(f"states {tuple(states.shape)} and values "
                         f"{tuple(values.shape)} must be one (..., W) shape")
    w_ptr, w_val = _scalar(w, dev, "w")
    p_ptr, p_val = _scalar(p, dev, "p")
    W = states.shape[-1]
    shape = tuple(states.shape[:-1]) + (2 * W,)
    s_out = torch.empty(shape, dtype=torch.int32, device=dev)
    v_out = torch.empty(shape, dtype=torch.int32, device=dev)
    if states.numel() == 0:
        return s_out, v_out
    _lib.launch("dd_expand", states.data_ptr(), values.data_ptr(), w_ptr,
                w_val, p_ptr, p_val, s_out.data_ptr(), v_out.data_ptr(),
                states.numel(), W, device=dev)
    expand_pool.launches += 1
    return s_out, v_out


expand_pool.launches = 0


def expand_layer_bulk(states: torch.Tensor, values: torch.Tensor, w, p
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(N,)`` nodes -> ``(2N,)`` children [0-arcs then 1-arcs]."""
    if states.ndim != 1:
        raise ValueError(f"expand_layer_bulk takes (N,) nodes, got "
                         f"{tuple(states.shape)}")
    return expand_pool(states, values, w, p)


def explore_fused(layer: torch.Tensor, state: torch.Tensor,
                  value: torch.Tensor, valid: torch.Tensor,
                  weights: torch.Tensor, profits: torch.Tensor, *,
                  width: int, n_vars: int):
    """One launch of ``explore.cu`` on ``(B,)`` subproblems: returns
    ``(primal, dual, exact, child layer, child state, child value)``, the
    first three ``(B,)``, the children ``(B, width)``.  ``layer``,
    ``state``, ``value``, ``weights`` and ``profits`` are int32, ``valid``
    bool, all on one CUDA device; ``weights`` and ``profits`` hold at least
    ``n_vars`` items.  ``explore_fused.launches`` counts the launches."""
    dev = _lib.check_cuda(layer, state, value, valid, weights, profits)
    if not 2 <= width <= 32:  # one pool slot per lane of a warp
        raise ValueError(f"explore.cu takes pool widths 2 to 32, got "
                         f"{width}")
    for name, t in (("layer", layer), ("state", state), ("value", value),
                    ("weights", weights), ("profits", profits)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool, got {valid.dtype}")
    if layer.ndim != 1 or any(t.shape != layer.shape
                              for t in (state, value, valid)):
        raise ValueError("layer, state, value and valid must be one (B,) "
                         "shape")
    b = layer.shape[0]
    if weights.ndim != 1 or profits.ndim != 1 \
            or min(weights.numel(), profits.numel()) < n_vars:
        raise ValueError(f"weights and profits must be (n,) with n >= "
                         f"n_vars = {n_vars}")
    i32 = dict(dtype=torch.int32, device=dev)
    primal, dual = torch.empty((b,), **i32), torch.empty((b,), **i32)
    exact = torch.empty((b,), dtype=torch.bool, device=dev)
    children = [torch.empty((b, width), **i32) for _ in range(3)]
    if b:
        _lib.launch("dd_explore", layer.data_ptr(), state.data_ptr(),
                    value.data_ptr(), valid.data_ptr(), weights.data_ptr(),
                    profits.data_ptr(), n_vars, width, b, primal.data_ptr(),
                    dual.data_ptr(), exact.data_ptr(),
                    *(c.data_ptr() for c in children), device=dev)
        explore_fused.launches += 1
    return (primal, dual, exact, *children)


explore_fused.launches = 0
