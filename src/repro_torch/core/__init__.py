"""Queue contract, virtual master and the DD solver (PyTorch port of ``repro.core``)."""

from repro_torch.core import relaxed as _relaxed  # noqa: F401  (registers "relaxed")
