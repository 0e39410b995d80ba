"""Models (port of ``repro.models``): the decoder family, for serving."""
