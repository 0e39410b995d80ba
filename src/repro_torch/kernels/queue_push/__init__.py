"""K2 ``ring_scatter`` and K3 ``ring_slice``: the owner-side bulk push and pop."""

from repro_torch.kernels.queue_push.ops import (DEFAULT_BLOCK, pop_slice,
                                                push_scatter, ring_scatter,
                                                ring_scatter_supported,
                                                ring_slice,
                                                ring_slice_supported)

__all__ = [
    "DEFAULT_BLOCK",
    "ring_scatter",
    "ring_scatter_supported",
    "ring_slice",
    "ring_slice_supported",
    "push_scatter",
    "pop_slice",
]
