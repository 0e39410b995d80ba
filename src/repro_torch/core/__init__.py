"""Queue contract, virtual master and the DD solver (PyTorch port of ``repro.core``)."""
