"""KV-cache utilities for serving (port of ``repro.serve.kv_cache``).

Model ``prefill`` returns caches sized to the prompt; decode needs head
room.  ``pad_cache`` grows every attention cache leaf (k/v, layout
(L, B, C, K, hd)) along the sequence axis to ``target_len`` — zero-fill
is safe because decode masks by position validity.  Enc-dec cross-attn
caches (fixed source) and any other leaf are left untouched.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import torch
import torch.nn.functional as F

Pytree = Any

__all__ = ["pad_cache", "cache_tokens"]


def _is_growable(path: Tuple[str, ...], leaf: Any) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim == 5
            and "cross" not in path and bool(path) and path[-1] in ("k", "v"))


def _map(fn, tree: Pytree, path: Tuple[str, ...] = ()) -> Pytree:
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def _leaves(tree: Pytree, path: Tuple[str, ...] = ()) -> Iterator:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def pad_cache(cache: Pytree, target_len: int) -> Pytree:
    """Grow attention k/v leaves to seq length ``target_len`` (axis 2)."""

    def pad(path, leaf):
        if not _is_growable(path, leaf) or leaf.shape[2] >= target_len:
            return leaf
        # F.pad lists (before, after) pairs from the LAST axis backwards.
        return F.pad(leaf, (0, 0, 0, 0, 0, target_len - leaf.shape[2]))

    return _map(pad, cache)


def cache_tokens(cache: Pytree) -> int:
    """Total KV slots held (for admission/capacity accounting)."""
    total = sum(leaf.shape[1] * leaf.shape[2]
                for path, leaf in _leaves(cache) if _is_growable(path, leaf))
    return total // 2  # k and v counted once
