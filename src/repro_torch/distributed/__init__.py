"""Resizing the steal runtime's worker set (PyTorch port of
``repro.distributed``).

  elastic   :func:`evacuate` / :func:`shrink` / :func:`grow` and the live
            resize of a padded runtime — dead rings drain through the
            ordinary exchange at proportion 1.0 before lanes go

The JAX package's one-lane-per-device runtime (``MeshStealRuntime``),
``launch_runtime`` and the serving lanes wait for the port's
``torch.distributed`` slice; this package resizes the stacked-lane
:class:`repro_torch.runtime.StealRuntime`.
"""

from repro_torch.distributed.elastic import evacuate, grow, shrink

__all__ = ["evacuate", "grow", "shrink"]
