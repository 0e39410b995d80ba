"""K1 ``ring_gather``: the steal-side ring-segment read."""
