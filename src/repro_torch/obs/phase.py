"""Phase-attributed time for steal-runtime rounds (PyTorch port of
``repro.obs.phase``).

A round is ``worker_body`` -> ``exchange`` -> ``splice`` ->
``adaptive_update``.  The JAX package cannot put a timer between them: a
jitted round is one opaque XLA program, so its probe re-runs truncated
prefix programs of the round on the same inputs and subtracts their
walls, and it estimates each round of a fused ``lax.scan`` block from
calibrated fractions, because a scan cannot be fenced per phase.

The port's rounds are issued from Python, so the boundaries are there to
mark.  :class:`PhaseClock` records one mark where each phase ends: a
``torch.cuda.Event(enable_timing=True)`` on the runtime's stream on a
CUDA device (no host sync, no kernel launch), ``time.perf_counter()`` on
the CPU.  The executor reads the elapsed times once per block, after the
block's existing read-back, and feeds :meth:`PhaseProbe.direct_sample`
for every round, fused blocks included, so ``phase_estimated`` stays
False and :attr:`PhaseProbe.calibrations` stays 0 in the port; the
calibration API is kept for callers that estimate.  Each block's rounds
partition its measured host wall: the last round's ``splice`` takes what
the marks do not cover (the read-back, the host's issue ahead of the
first mark, rounds past a drain).

Clocks: the phase times are device-timeline times and the wall is host
time.  In a host-bound round the device waits on the host's issue, so a
phase's device time follows how long the host took to issue it.  In
:meth:`~repro_torch.runtime.executor.StealRuntime.round` the adaptive
update is the host controller, timed on the host after the read-back.

With no probe, or a disabled one, the runtime makes no mark and creates
no event; with one, the results are bit-identical (a mark records a time
and touches no tensor).

Host spans.  :func:`span` names a stretch of the program's host code:
``repro.solve`` around a solve, ``repro.block`` around a fused block,
``repro.round``, ``repro.worker_body``, ``repro.superstep`` and the
layers inside them.  Off by default, a span is one test of a module flag
and a shared null context.  On (:func:`enable_spans`, or inside a
:func:`trace_span` profile), it is a ``torch.profiler.record_function``
range: the profiler stamps it on the clock of the device operations it
traces and links each operation to the host operation that launched it,
so a trace says which layer of the round the host was issuing while the
device waited.  Spans live in the profiler's memory until it stops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves

__all__ = ["PHASES", "PhaseSample", "PhaseProbe", "PhaseClock",
           "timed_call", "trace_span", "span", "enable_spans"]

# Phase order is load-bearing: calibration deltas and trace children are
# emitted in this order.
PHASES: Tuple[str, ...] = ("worker_body", "exchange", "splice",
                           "adaptive_update")


@dataclasses.dataclass(frozen=True)
class PhaseSample:
    """One round's time split, in seconds.

    ``estimated`` marks a split made from calibrated fractions rather
    than at measured boundaries.  ``total`` is the time attributed to the
    round — the phases sum to it by construction.
    """

    worker_body: float
    exchange: float
    splice: float
    adaptive_update: float
    total: float
    estimated: bool = False

    def as_record(self) -> Dict[str, Any]:
        """The kwargs ``Telemetry.record(phases=...)`` consumes."""
        return {
            "t_worker": self.worker_body,
            "t_exchange": self.exchange,
            "t_splice": self.splice,
            "t_adaptive": self.adaptive_update,
            "t_round": self.total,
            "phase_estimated": self.estimated,
        }


# the program's host spans: off until enable_spans(True)
_SPANS_ON = False
_NO_SPAN = contextlib.nullcontext()
SPAN_PREFIX = "repro."


def span(name: str):
    """The host span ``repro.<name>``: a ``torch.profiler.record_function``
    range while spans are on, the one shared null context otherwise."""
    if not _SPANS_ON:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def enable_spans(on: bool = True) -> bool:
    """Turn the program's host spans on or off; returns the previous
    setting, for the caller to restore."""
    global _SPANS_ON
    prev, _SPANS_ON = _SPANS_ON, bool(on)
    return prev


def _fence(out) -> None:
    devices = {leaf.device for leaf in tree_leaves(out)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def timed_call(fn, args) -> Tuple[float, Any]:
    """Wall seconds of one call, fenced on its OUTPUTS
    (``torch.cuda.synchronize`` on the device of every CUDA tensor among
    them).  The caller is responsible for input readiness."""
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out)
    return time.perf_counter() - t0, out


@contextlib.contextmanager
def trace_span(name: str):
    """Opt-in ``torch.profiler`` wrapping of one block: when
    ``REPRO_TRACE=<dir>`` is set, the block runs under
    ``torch.profiler.profile`` (CPU and, where there is one, CUDA
    activities) and ``<dir>/<name>.json`` receives its Chrome trace
    (kernel-level detail — it complements, not replaces, the logical
    trace :mod:`repro_torch.obs.trace` builds from telemetry), with the
    program's host spans (:func:`span`) on for the block.  A no-op
    otherwise, and inside a profile that is already running."""
    trace_dir = os.environ.get("REPRO_TRACE")
    if not trace_dir or torch.autograd._profiler_enabled():
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prev = enable_spans(True)
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        enable_spans(prev)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))


class PhaseClock:
    """The phase-boundary marks of one block of rounds on ``device``.

    :meth:`start` opens the block; :meth:`mark` closes the phase it names
    (the time since the previous mark goes to that phase), and the
    ``adaptive_update`` mark closes a round.  On a CUDA device a mark
    records a timing event on the device's current stream, drawn from a
    pool the clock reuses from block to block; on the CPU it reads
    ``time.perf_counter()``.  :meth:`rounds` reads the block's times —
    call it after the block's read-back, when every event has completed
    (``elapsed_time`` does not synchronise).
    """

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._pool: List[torch.cuda.Event] = []
        self._marks: List[Tuple[Optional[str], Any]] = []

    def start(self) -> None:
        self._marks = []
        self.mark(None)

    def mark(self, phase: Optional[str]) -> None:
        if not self._cuda:
            self._marks.append((phase, time.perf_counter()))
            return
        i = len(self._marks)
        if i == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        event = self._pool[i]
        event.record(torch.cuda.current_stream(self.device))
        self._marks.append((phase, event))

    def _seconds(self, a, b) -> float:
        if self._cuda:
            return a.elapsed_time(b) / 1e3
        return b - a

    def rounds(self) -> List[Dict[str, float]]:
        """Seconds per phase of each round of the block, in order (a last
        round without its ``adaptive_update`` mark included)."""
        out: List[Dict[str, float]] = []
        cur: Optional[Dict[str, float]] = None
        for (_, a), (phase, b) in zip(self._marks, self._marks[1:]):
            if cur is None:
                cur = dict.fromkeys(PHASES, 0.0)
            cur[phase] += self._seconds(a, b)
            if phase == PHASES[-1]:
                out.append(cur)
                cur = None
        if cur is not None:
            out.append(cur)
        return out


class PhaseProbe:
    """Host-side probe state: the enable switch plus the per-worker-fn
    calibration cache the JAX package uses for fused attribution.

    ``calibrate_every`` is the re-calibration cadence in ROUNDS.  The
    port's runtime measures every round directly
    (:meth:`direct_sample`) and never calibrates; the cache and
    :meth:`estimated_sample` keep the JAX API and arithmetic.
    """

    def __init__(self, *, enabled: bool = True,
                 calibrate_every: int = 512) -> None:
        self.enabled = bool(enabled)
        self.calibrate_every = max(int(calibrate_every), 1)
        self.rounds_attributed = 0
        self.calibrations = 0
        self._fractions: Dict[Any, np.ndarray] = {}
        self._cal_round: Dict[Any, int] = {}

    # -- calibration cache ---------------------------------------------------

    def needs_calibration(self, key: Any, rounds_run: int) -> bool:
        if key not in self._fractions:
            return True
        return rounds_run - self._cal_round[key] >= self.calibrate_every

    def store_calibration(self, key: Any, parts, rounds_run: int) -> None:
        """Cache phase fractions from raw per-phase seconds (clamped to
        >= 0 and normalized; a degenerate all-zero measurement falls back
        to a uniform split rather than NaN)."""
        parts = np.maximum(np.asarray(parts, dtype=np.float64), 0.0)
        total = float(parts.sum())
        if total <= 0.0:
            parts = np.full((len(PHASES),), 1.0 / len(PHASES))
        else:
            parts = parts / total
        self._fractions[key] = parts
        self._cal_round[key] = int(rounds_run)
        self.calibrations += 1

    def fractions(self, key: Any) -> np.ndarray:
        return self._fractions[key]

    # -- sample construction -------------------------------------------------

    def direct_sample(self, *, t_worker: float, t_exchange: float,
                      t_full: float, t_adaptive: float) -> PhaseSample:
        """Attribution from measured boundaries: ``t_worker`` and
        ``t_exchange`` are the times from the round's start to the end of
        the worker body and of the exchange, ``t_full`` to the end of the
        splice.  Negative differences (clock noise on a near-empty phase)
        clamp to zero; the residual re-lands in ``splice`` so phases
        still sum to the measured total."""
        worker = max(t_worker, 0.0)
        exchange = max(t_exchange - t_worker, 0.0)
        adaptive = max(t_adaptive, 0.0)
        splice = max(t_full - worker - exchange, 0.0)
        self.rounds_attributed += 1
        return PhaseSample(worker_body=worker, exchange=exchange,
                           splice=splice, adaptive_update=adaptive,
                           total=worker + exchange + splice + adaptive,
                           estimated=False)

    def estimated_sample(self, key: Any, per_round_s: float,
                         n: int = 1) -> PhaseSample:
        """One round's share of a block's wall, split by the cached
        calibration fractions; the same sample serves all ``n`` rounds
        of the block."""
        f = self.fractions(key)
        parts = [float(per_round_s) * float(f[i]) for i in range(len(PHASES))]
        self.rounds_attributed += int(n)
        return PhaseSample(worker_body=parts[0], exchange=parts[1],
                           splice=parts[2], adaptive_update=parts[3],
                           total=float(per_round_s), estimated=True)
