"""``repro_torch.analysis`` — the checked-correctness layer (PyTorch port
of ``repro.analysis``), three ways:

* :mod:`repro_torch.analysis.linearize` — an exhaustive model checker of
  one owner and one stealer driving a real queue through a real backend
  against a sequential specification on small rings: exact
  linearizability for the fenced backends, the bounded-multiplicity
  contract for the split ``relaxed`` steal.
* :mod:`repro_torch.analysis.lint` — an AST pass over the port's source:
  kernel-package completeness, the in-place kernels' ``donate=``
  mirror, use-after-donate and ``use_kernel``-era patterns.
* :mod:`repro_torch.analysis.sanitize` — the runtime sanitizer:
  ``REPRO_CHECK=1`` (or ``make_ops(..., check=True)``) holds every
  backend op, lane by lane, to its contract.

Each pass has a CLI: ``python -m repro_torch.analysis.lint`` and
``python -m repro_torch.analysis.linearize``.
"""

from repro_torch.analysis.sanitize import (CheckedBulkOps, SanitizerError,
                                           assert_clean, checking_enabled,
                                           reset_violations, violations)

__all__ = ["CheckedBulkOps", "SanitizerError", "assert_clean",
           "checking_enabled", "reset_violations", "violations"]
