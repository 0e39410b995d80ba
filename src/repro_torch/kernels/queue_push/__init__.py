"""K2 ``ring_scatter`` and K3 ``ring_slice``: the owner-side bulk push and pop."""
