"""K5 ``dd_expand``: decision-diagram layer expansion."""
