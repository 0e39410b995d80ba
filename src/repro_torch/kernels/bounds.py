"""The work of the float kernels K6 and K7: the operations and the bytes
one call needs, and the trace the dry run takes of them.

``chip_smoke.py``'s phase 1 turns these counts into each kernel's bound
(the larger of its operations over the card's peak rate and its bytes
over the memory rate); ``launch.dryrun``'s trace charges them for every
forward call of a wrapper (:func:`kernel`), whatever runs inside: the
CUDA kernel, the plain version on the CPU, or nothing on ``meta`` (where
the plain version must not run: it would count the ``(S, T)`` logits
that K6 never forms).

* K6 (:func:`flash_counts`): ``4 hd`` operations per visible (query,
  key) pair per query head (``q k`` and ``p v``), and q, k, v and the
  output each read or written once.
* K7 (:func:`ssd_counts`): per batch and chunk of length ``L``, ``C
  B^T`` over the ``L (L + 1) / 2`` causal pairs once (B and C are per
  batch); per head the causal half of ``(G L) x``, ``C state^T`` for
  every chunk after the first (the first's carried state is zero) and
  the state update; and the bytes of x, dt, A, Bm, Cm, D, y and the
  final state, each once.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["visible_pairs", "flash_counts", "ssd_counts", "kernel",
           "SINKS"]

# Objects that follow the kernels' work (the dry run's ``StepTrace``):
# ``begin(name, ops, nbytes)`` as a wrapper's forward starts, ``end()``
# as it returns.  What dispatches between the two is the kernel's own
# work (its plain version, on the CPU), counted at the kernel's counts.
SINKS: List[object] = []


@contextlib.contextmanager
def kernel(name: str, ops: int, nbytes: int):
    """One kernel call's forward, ``ops`` operations and ``nbytes`` bytes,
    reported to every sink around what it dispatches."""
    for sink in SINKS:
        sink.begin(name, int(ops), int(nbytes))
    try:
        yield
    finally:
        for sink in SINKS:
            sink.end()


def visible_pairs(S: int, T: int, *, causal: bool,
                  window: Optional[int]) -> int:
    """The (query, key) pairs K6's masks leave visible: query row ``i``
    right-aligned at key ``i + T - S`` sees keys up to it (causal) and
    after ``i + T - S - window`` (windowed); ``visible(S, T).sum()`` of
    ``flash_attention.ref`` without forming the ``(S, T)`` mask."""
    qp = np.arange(S, dtype=np.int64) + (T - S)
    hi = np.minimum(qp, T - 1) if causal else np.full(S, T - 1, np.int64)
    lo = np.maximum(qp - window + 1, 0) if window is not None else \
        np.zeros(S, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_counts(B: int, S: int, T: int, H: int, K: int, hd: int, *,
                 causal: bool, window: Optional[int], itemsize: int
                 ) -> Tuple[int, int]:
    """(operations, bytes) of one K6 call: q ``(B, S, H, hd)`` against k,
    v ``(B, T, K, hd)``."""
    ops = 4 * B * H * hd * visible_pairs(S, T, causal=causal, window=window)
    nbytes = (2 * B * S * H * hd + 2 * B * T * K * hd) * itemsize
    return ops, nbytes


def ssd_counts(B: int, S: int, nh: int, hd: int, ns: int, Q: int,
               itemsize: int) -> Tuple[int, int]:
    """(operations, bytes) of one K7 scan: x ``(B, S, nh, hd)``, Bm and Cm
    ``(B, S, ns)`` of ``itemsize`` bytes, chunk ``Q``."""
    ops = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        pairs = L * (L + 1) // 2
        ops += B * 2 * pairs * ns
        ops += B * nh * (2 * pairs * hd + 2 * L * hd * ns * (c0 > 0)
                         + 2 * L * hd * ns)
    nbytes = (2 * B * S * nh * hd + 2 * B * S * ns) * itemsize \
        + (B * S * nh + 2 * nh + B * nh * hd * ns) * 4
    return ops, nbytes
