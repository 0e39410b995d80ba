"""The backward of a kernel that has none of its own.

K6 and K7 are forward kernels: they fill their outputs through raw
pointers, so autograd cannot see through them.  Their wrappers put each
CUDA launch in a ``torch.autograd.Function`` whose backward calls
:func:`plain_grads`: it recomputes the kernel's plain version from the
saved inputs and returns that function's gradients.  The JAX package has
no backward kernel either (no ``custom_vjp`` under its ``kernels/``): its
models take the jnp path, whose gradient is XLA's autodiff.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["plain_grads"]


def plain_grads(plain: Callable, inputs: Sequence[torch.Tensor],
                grad_outputs: Sequence[Optional[torch.Tensor]],
                needs: Sequence[bool], *args, **kwargs
                ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``plain(*inputs, *args, **kwargs)`` with respect to the
    ``inputs`` whose ``needs`` flag is set (``None`` for the others), given
    the gradients of its outputs (a tensor or a tuple; an output whose
    gradient is ``None`` contributes nothing)."""
    leaves = [t.detach().requires_grad_(bool(n)) for t, n in
              zip(inputs, needs)]
    wrt = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        outs = plain(*leaves, *args, **kwargs)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        if not wrt or not pairs:
            return tuple(None for _ in leaves)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)
