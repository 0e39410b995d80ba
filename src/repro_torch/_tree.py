"""Payload pytrees and devices: the two small helpers every module shares.

A queue item is a pytree of tensors, as in the JAX package: a tensor, a
dict (leaves in sorted key order, as JAX orders them), or a tuple / list /
NamedTuple of such.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path",
           "tree_unflatten", "resolve_device"]


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_leaves_with_path(tree: Any, prefix: str = ""
                          ) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in :func:`tree_leaves` order, each key the
    JAX package's checkpoint path key: entry names joined by ``/`` — a
    dict's key, a NamedTuple's field name, a sequence's index."""
    def join(name) -> str:
        return f"{prefix}/{name}" if prefix else str(name)

    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, x in zip(tree._fields, tree)
                for kv in tree_leaves_with_path(x, join(name))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in tree_leaves_with_path(x, join(i))]
    return [(prefix, tree)]


def tree_unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in
    :func:`tree_leaves` order."""
    return _build(template, iter(leaves))


def _build(t: Any, it) -> Any:
    # A module-level recursion: a recursive closure would be a reference
    # cycle holding ``it``, and through it every leaf, until the cyclic
    # garbage collector ran (gigabytes of gradients and moments a step).
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_build(x, it) for x in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_build(x, it) for x in t)
    return next(it)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """An entry point's device: ``None`` means CUDA, and a CUDA device is
    refused when there is none — the port never carries on quietly on the
    CPU.  Pass ``"cpu"`` to ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
