"""AdamW, functional (port of ``repro.train.optimizer``).

The JAX package's function, not ``torch.optim.AdamW``'s: float32 moments,
one clip of the global gradient norm, bias correction from ``b ** step``
in float32, weight decay only on leaves of two or more dimensions (not on
norms), the cosine schedule with linear warm-up, and an optional float32
master copy of the parameters (``master_weights``: the parameters, e.g.
bfloat16, are a cast of it).  The state is a tree of tensors, as
``OptState`` is in the JAX package, so a checkpoint of ``(params, opt)``
written by either package restores into the other.  ``opt_state_specs``
lays the state out like the parameters (the JAX package's GSPMD layout:
the moments and the master copy take each parameter's spec).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.layers import P

Pytree = Any

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "opt_state_specs", "cosine_lr"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # parameters in a low precision, the float32 truth in ``master``
    master_weights: bool = False


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Pytree
    v: Pytree
    master: Pytree          # float32 copy of the parameters, or ()


def adamw_init(params: Pytree, *, master_weights: bool = False) -> OptState:
    """Zero moments (float32) beside ``params``, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    master = tree_map(lambda p: p.float().clone(), params) \
        if master_weights else ()
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params),
                    master=master)


def opt_state_specs(param_specs: Pytree, *,
                    master_weights: bool = False) -> OptState:
    """The optimizer state's spec tree: ``P()`` for the step, the
    parameters' specs for the moments and the master copy."""
    return OptState(step=P(), m=param_specs, v=tree_map(lambda s: s,
                                                        param_specs),
                    master=(tree_map(lambda s: s, param_specs)
                            if master_weights else ()))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine to 0 at
    ``total_steps``; float32, as the JAX package computes it."""
    f32 = torch.float32
    warm = torch.clamp(step.to(f32) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(f32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def adamw_update(cfg: AdamWConfig, grads: Pytree, state: OptState,
                 params: Pytree) -> Tuple[Pytree, OptState, dict]:
    """Returns ``(new_params, new_state, {"grad_norm", "lr"})``; nothing is
    updated in place.  With ``master_weights`` the float32 update applies
    to ``state.master`` and the parameters are its cast."""
    step = state.step + 1
    flat_g = tree_leaves(grads)
    gnorm = _global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device),
                          step.float())
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device),
                          step.float())
    use_master = cfg.master_weights and state.master != ()

    def upd(p, g, m, v, pm):
        g = g.float() * scale
        m = cfg.b1 * m + (1.0 - cfg.b1) * g
        v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        src = pm if use_master else p.float()
        if p.ndim >= 2:  # decay matrices, not norms
            delta = delta + cfg.weight_decay * src
        new_master = src - lr * delta
        return new_master.to(p.dtype), m, v, new_master

    flat_p = tree_leaves(params)
    flat_pm = tree_leaves(state.master) if use_master else [None] * len(
        flat_p)
    out = [upd(*a) for a in zip(flat_p, flat_g, tree_leaves(state.m),
                                tree_leaves(state.v), flat_pm)]
    new_p, new_m, new_v, new_master = (
        tree_unflatten(params, [o[i] for o in out]) for i in range(4))
    return new_p, OptState(step=step, m=new_m, v=new_v,
                           master=new_master if use_master else ()), \
        {"grad_norm": gnorm, "lr": lr}
