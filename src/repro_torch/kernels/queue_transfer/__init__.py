"""K4 ``ring_transfer``: the compact exchange's thief-side cut-and-splice."""
