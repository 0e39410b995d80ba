"""Train step: loss -> gradients -> AdamW (port of ``repro.train.trainer``),
with optional microbatch gradient accumulation.

Parameters stay a tree of tensors that need no gradient; a step takes the
loss's gradient with respect to detached copies of them
(:func:`value_and_grad`, the counterpart of ``jax.value_and_grad``), so
the caller's tree is never touched and the step is a function, as in the
JAX package.  On the card the model's forward reaches K6 and K7, whose
CUDA launches carry their plain versions' gradients.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

Pytree = Any

__all__ = ["make_train_step", "value_and_grad"]


def value_and_grad(loss_fn: Callable, params: Pytree, batch
                   ) -> Tuple[torch.Tensor, Pytree]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``: grads a tree like
    ``params``, each leaf in its parameter's dtype (zeros for a leaf the
    loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model, opt_cfg: AdamWConfig,
                    microbatch: int = 0) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``loss``, ``grad_norm`` and ``lr`` (0-d tensors).

    ``microbatch > 1`` splits the batch's leading dim into that many
    chunks, accumulates their float32 gradients, averages them and takes
    the mean of the chunks' losses."""

    def train_step(params, opt_state: OptState, batch):
        if microbatch and microbatch > 1:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(microbatch):
                part = {k: v.reshape((microbatch, v.shape[0] // microbatch)
                                     + tuple(v.shape[1:]))[i]
                        for k, v in batch.items()}
                loss, g = value_and_grad(model.loss_fn, params, part)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                losses.append(loss)
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(model.loss_fn, params, batch)
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, params)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step
