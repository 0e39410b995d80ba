"""Atomic, elastic checkpoints (PyTorch port of ``repro.train.checkpoint``).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a tmp
dir and renamed (atomic on POSIX), so a crash mid-write never corrupts
the latest checkpoint; ``keep`` old steps are retained.

Arrays are saved as full host arrays keyed by their pytree path — the
JAX package's keys (``queues/buf/<leaf>``, ``queues/lo``,
``queues/size``, ``proportion``, ``rounds_run``, ``fault/<name>``;
:func:`repro_torch._tree.tree_leaves_with_path`) and dtypes — so a
checkpoint written by either package restores into the other, and onto
any device: ``restore(..., device=)`` places every leaf there.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves_with_path, tree_unflatten
from repro_torch.core.ops import from_numpy, to_numpy

Pytree = Any

__all__ = ["save", "restore", "latest_step", "latest_steps", "Checkpointer"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf)
    return np.asarray(leaf)


def _flatten(tree: Pytree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in tree_leaves_with_path(tree)}


def save(ckpt_dir: str, step: int, tree: Pytree,
         extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically write the checkpoint of ``step``; drop all but the
    newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for s in latest_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
    return final


def latest_steps(ckpt_dir: str):
    """Every step with a checkpoint under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Pytree, step: Optional[int] = None,
            device=None) -> Tuple[Pytree, int, dict]:
    """Load ``step`` (default: the latest) into ``template``'s structure,
    every leaf a tensor on ``device`` (default: the CPU); a leaf's shape
    must match the template's.  Returns ``(tree, step, extra)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    leaves = []
    for key, leaf in tree_leaves_with_path(template):
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, the template {tuple(leaf.shape)}")
        t = from_numpy(arr, device or "cpu")
        if (isinstance(leaf, torch.Tensor) and t.dtype != leaf.dtype
                and t.element_size() == leaf.element_size()):
            t = t.view(leaf.dtype)  # bfloat16 travels as its bits
        leaves.append(t)
    return tree_unflatten(template, leaves), int(meta["step"]), \
        meta.get("extra", {})


class Checkpointer:
    """Directory, cadence and keep-k in one object."""

    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3):
        self.dir = ckpt_dir
        self.every = max(every, 1)
        self.keep = keep

    def maybe_save(self, step: int, tree: Pytree,
                   extra: Optional[dict] = None) -> Optional[str]:
        if step % self.every == 0:
            return save(self.dir, step, tree, extra, keep=self.keep)
        return None
