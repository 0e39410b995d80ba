"""Train step: loss -> gradients -> AdamW (port of ``repro.train.trainer``),
with optional microbatch gradient accumulation.

Parameters stay a tree of tensors that need no gradient; a step takes the
loss's gradient with respect to detached copies of them
(:func:`value_and_grad`, the counterpart of ``jax.value_and_grad``), so
the caller's tree is never touched and the step is a function, as in the
JAX package.  On the card the model's forward reaches K6 and K7, whose
CUDA launches carry their plain versions' gradients.

Under ``with mesh.spmd():`` the step is the sharded one (the JAX
package's jitted step with ``param_specs`` / ``opt_state_specs``
shardings): parameters, optimizer state and batch are this rank's
blocks, each gradient leaf comes out as this rank's block of the
unsharded gradient (an FSDP leaf's gather is reduce-scattered in the
backward; a leaf replicated over a batch axis is summed over it here),
the clip's norm is the global one and AdamW updates the local blocks.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.layers import _spmd_mesh, batch_entry
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_update

Pytree = Any

__all__ = ["make_train_step", "TrainState", "value_and_grad", "sync_grads"]


class TrainState(NamedTuple):
    """What a train step carries from one step to the next: the parameter
    tree and the optimizer state.  The step itself takes and returns them
    as two arguments, as in the JAX package."""

    params: Pytree
    opt: OptState


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


def sync_grads(grads: Pytree, specs: Pytree, sh) -> Pytree:
    """In the sharded step: each leaf summed over the batch axes its spec
    does not split it over (its rows' gradients came from this rank's
    rows only); outside it, ``grads`` itself."""
    mesh = _spmd_mesh()
    rows = batch_entry(sh)
    if mesh is None or not rows:
        return grads

    def one(g, spec):
        held = {a for e in spec for a in mesh._axes(e)}
        for a in rows:
            if a not in held:
                g = mesh.all_reduce(g, a, "sum")
        return g

    return tree_map(one, grads, specs)


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
        specs = None
        if _spmd_mesh() is not None:
            specs = model.param_specs()
            grads = sync_grads(grads, specs, model.sh)
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, params,
                                                      specs)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step
