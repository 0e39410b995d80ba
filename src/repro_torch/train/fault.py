"""Straggler detection (port of ``StragglerMonitor`` from
``repro.train.fault``).

``StragglerMonitor`` keeps an EMA of step wall-time; a step slower than
``threshold x`` the EMA marks a straggler.  The serving engine keeps one
per replica and feeds its verdicts to the shared failure detector.  The
JAX package's ``GracefulExit`` and ``run_supervised`` belong to the
training loop and wait for the training slice.
"""

from __future__ import annotations

import time
from typing import Optional

__all__ = ["StragglerMonitor"]


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
