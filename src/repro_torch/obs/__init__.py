"""repro_torch.obs — observability for the steal runtime (PyTorch port of
``repro.obs``).

Three cooperating pieces:

* :mod:`repro_torch.obs.phase` — each round's time attributed to
  ``worker_body`` / ``exchange`` / ``splice`` / ``adaptive_update`` from
  marks at the phase boundaries (CUDA events on the device), read once
  per block (off by default; bit-identical when on).
* :mod:`repro_torch.obs.trace` — Chrome-trace/Perfetto JSON export of one
  :class:`~repro_torch.runtime.telemetry.Telemetry` stream: round spans
  with phase children, wave spans, per-request flows, fault/detector
  instant events on one timeline.
* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  Prometheus text exposition and JSON snapshots, fed by the telemetry,
  the failure detector, both admission masters and PagedQueue spill
  accounting.
"""

from repro_torch.obs.metrics import (MetricsRegistry,  # noqa: F401
                                     master_metrics, runtime_metrics)
from repro_torch.obs.phase import PhaseProbe, PhaseSample  # noqa: F401
from repro_torch.obs.trace import export_trace, validate_trace  # noqa: F401

__all__ = ["PhaseProbe", "PhaseSample", "MetricsRegistry",
           "runtime_metrics", "master_metrics", "export_trace",
           "validate_trace"]
