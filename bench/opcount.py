"""Operations and bytes of the DD explore, counted from its inputs alone.

A frozen copy of the arithmetic of ``chip_smoke.explore_ops``, so that a
change to the program cannot move the yardstick.  For each valid
subproblem, its restricted and its relaxed DD each walk the layers from
its start layer to ``n_vars``; each layer of a pool of ``width`` nodes
costs 4 operations per child for the arcs (2 * width children) and two
sorts of the children, 2W log2(2W) comparisons each (the merge of equal
states and the top-k by value).  The exact DD's walk is left out: how far
it goes depends on the explore's outputs.  So the count is a lower bound
of the work, and a share of the roofline taken from it can only read low.

Bytes: the ``(B,)`` inputs (layer, state, value: int32; valid: bool) and
the weights and profits read once; the bounds, the exact flags and the
``(B, width)`` children written once.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["ops_per_layer", "explore_layers", "explore_ops",
           "explore_bytes"]


def ops_per_layer(width: int) -> int:
    """Integer operations of one DD layer over a pool of ``width``."""
    k = 2 * width
    return 4 * k + 2 * k * int(math.ceil(math.log2(k)))


def explore_layers(layer, valid, n_vars: int):
    """Layers the restricted and relaxed DDs of the valid subproblems
    walk: 2 * (n_vars - layer) each.  ``layer`` and ``valid`` are NumPy
    arrays or tensors alike; the sum comes back 0-d, where they are."""
    walk = (n_vars - layer.clip(min=0)).clip(min=0)
    return 2 * (walk * valid).sum()


def explore_ops(layer, valid, *, width: int, n_vars: int) -> int:
    """Integer operations the restricted and relaxed DDs of these
    subproblems need at least."""
    layers = explore_layers(np.asarray(layer, dtype=np.int64),
                            np.asarray(valid, dtype=bool), n_vars)
    return int(layers) * ops_per_layer(width)


def explore_bytes(batch: int, *, width: int, n_vars: int) -> int:
    """Bytes one explore of ``batch`` rows reads and writes at least."""
    return (batch * (3 * 4 + 1) + 2 * n_vars * 4 + batch * (2 * 4 + 1)
            + 3 * batch * width * 4)
