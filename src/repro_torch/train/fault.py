"""Fault tolerance: signal-triggered stops, straggler detection and a
supervised restart loop (PyTorch port of ``repro.train.fault``; none of
it uses a framework).

* ``GracefulExit`` — SIGTERM / SIGINT set a flag; a drive loop checks it
  between steps and writes a final snapshot before it exits (preemption
  handling: eviction sends SIGTERM).
* ``StragglerMonitor`` — EMA of step wall-time; a step slower than
  ``threshold x`` the EMA marks a straggler.  The serving engine keeps
  one per replica and feeds its verdicts to the shared failure detector.
* ``run_supervised`` — restart-on-crash wrapper: run the loop; on an
  unhandled exception, run it again from the latest checkpoint, up to
  ``max_restarts`` times (``launch/resilient.py`` drives the steal
  runtime with it).
"""

from __future__ import annotations

import signal
import time
import traceback
from typing import Callable, Optional

__all__ = ["GracefulExit", "StragglerMonitor", "run_supervised"]


class GracefulExit:
    """Context manager: while active, SIGTERM / SIGINT set
    :attr:`requested` instead of ending the process; the previous
    handlers come back on exit."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def _handler(self, signum, frame):
        self.requested = True

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        return False


class StragglerMonitor:
    """EMA step timer; ``observe()`` returns True when this step was a
    straggler (> threshold x EMA)."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.straggler_steps = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def observe(self) -> bool:
        if self._t0 is None:
            return False
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (self.n > self.warmup
                        and dt > self.threshold * self.ema)
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        if is_straggler:
            self.straggler_steps += 1
        return is_straggler


def run_supervised(run: Callable[[Optional[int]], int],
                   max_restarts: int = 3,
                   on_restart: Optional[Callable[[int, BaseException], None]] = None
                   ) -> int:
    """Call ``run(resume_step)``; on a crash, call it again with ``-1``
    (restore from the latest checkpoint — ``run`` does the restoring),
    up to ``max_restarts`` times.  ``KeyboardInterrupt``, ``SystemExit``
    and ``GeneratorExit`` are deliberate stops and propagate at once.
    Returns what ``run`` returned."""
    resume: Optional[int] = None
    for attempt in range(max_restarts + 1):
        try:
            return run(resume)
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except BaseException as e:  # noqa: BLE001 — restart on anything
            if attempt == max_restarts:
                raise
            traceback.print_exc()
            if on_restart is not None:
                on_restart(attempt, e)
            resume = -1  # restore from the latest checkpoint
    raise RuntimeError("unreachable")
