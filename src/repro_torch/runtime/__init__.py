"""The steal runtime: executor, adaptive proportion, telemetry (port of ``repro.runtime``)."""
