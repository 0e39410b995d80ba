"""Plain PyTorch version of K5 ``dd_expand``: one decision-diagram layer.

Each live node (state >= 0) emits a 0-arc child (state, value) and, when
feasible (state >= w), a 1-arc child (state - w, value + p); dead slots
and infeasible arcs give (-1, -2^30).  Nodes lie along the last dim of a
``(..., W)`` pool and each row's children are laid out ``[0-arcs | 1-arcs]``
in ``(..., 2W)``: for ``(N,)`` nodes that is the JAX package's
``expand_ref`` layout, for the solver's ``(B, W)`` pools its
``core/dd/diagram.expand_layer`` under ``vmap``.  int32 throughout; ``w``
and ``p`` are Python ints or 0-d int32 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["NEG", "expand_ref"]

NEG = -(2 ** 30)


def expand_ref(states: torch.Tensor, values: torch.Tensor, w, p
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    live = states >= 0
    s0 = torch.where(live, states, -1)
    v0 = torch.where(live, values, NEG)
    feas = live & (states >= w)
    s1 = torch.where(feas, states - w, -1)
    v1 = torch.where(feas, values + p, NEG)
    return torch.cat([s0, s1], dim=-1), torch.cat([v0, v1], dim=-1)
