"""Automatic failure detection: healthy -> suspected -> dead, revivable
(restated from ``repro.runtime.detector``, which uses no framework; the
tests hold the two equal on the same observation traces).

A lane (here: a serving replica) is not declared dead; it stops answering,
or answers late.  This module is the policy that INFERS death from
behaviour, configured once for every owner.

The detector is host-side and observation-driven: it never touches device
state.  Callers feed it one boolean observation per (lane, round) —
``slow=True`` when the lane missed its deadline (a
:class:`repro_torch.train.fault.StragglerMonitor` timeout, a wall-clock
wave straggler) — and it answers with the lane's state, firing the
escalation callbacks its owner registered:

* ``on_suspect(lane)`` — the lane crossed ``suspect_after`` consecutive
  slow observations.  Fired on EVERY slow observation at or past the
  threshold (not just the crossing), so the owner can keep a temporary
  proportion boost alive for as long as the lane keeps lagging; the
  admission master wires this to ``note_straggler``.
* ``on_dead(lane)`` — the streak reached ``dead_after``: the lane is
  declared dead (the admission master evicts the replica).  A dead lane's
  subsequent observations are ignored until :meth:`FailureDetector.revive`.
* ``on_revive(lane)`` — an explicit revival (re-admission): all streak
  state clears, the lane restarts healthy.

Determinism: the detector is a pure function of its observation sequence.
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable, List, Optional

__all__ = ["DetectorPolicy", "FailureDetector",
           "HEALTHY", "SUSPECTED", "DEAD"]

HEALTHY = "healthy"
SUSPECTED = "suspected"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class DetectorPolicy:
    """The one escalation policy every layer shares.

    Attributes:
      suspect_after: consecutive slow observations before a lane is
        SUSPECTED (straggler boost territory).
      dead_after: consecutive slow observations before a lane is
        declared DEAD (a real ``kill_lane``).  ``None`` disables the
        death escalation entirely — the detector then only ever
        suspects, which is how a boost-only owner (no fault layer)
        runs it.
      healthy_after: consecutive on-time observations before a
        SUSPECTED lane is cleared back to HEALTHY.
      boost_rounds / boost_factor: the ``note_straggler`` proportion
        boost parameters the owner applies per ``on_suspect`` firing.
      wall_clock: ALSO classify real measured dispatch wall times fed
        through :meth:`FailureDetector.observe_wall` (the JAX package's
        runtime feeds per-round dispatch walls when this is set; the
        port's runtime does not yet).  Off by default: wall observations
        are inherently non-deterministic.
      wall_slow_factor: a wall observation is "slow" when it exceeds
        this multiple of the lane's rolling baseline (median of its
        ``wall_window`` most recent observations).
      wall_window: rolling-baseline window length, in observations; a
        lane is never judged before it has ``max(4, wall_window // 4)``
        samples of history.
      wall_kill: let wall-driven streaks escalate all the way to DEAD.
        Off by default — a collective dispatch wall cannot finger WHICH
        lane is slow, so by default wall slowness only ever suspects
        (boosting the steal proportion), never kills.
    """

    suspect_after: int = 2
    dead_after: Optional[int] = 6
    healthy_after: int = 2
    boost_rounds: int = 4
    boost_factor: float = 1.5
    wall_clock: bool = False
    wall_slow_factor: float = 2.0
    wall_window: int = 32
    wall_kill: bool = False

    def __post_init__(self):
        if self.suspect_after < 1:
            raise ValueError(f"suspect_after must be >= 1, "
                             f"got {self.suspect_after}")
        if self.healthy_after < 1:
            raise ValueError(f"healthy_after must be >= 1, "
                             f"got {self.healthy_after}")
        if self.dead_after is not None and self.dead_after < self.suspect_after:
            raise ValueError(
                f"dead_after={self.dead_after} must be >= "
                f"suspect_after={self.suspect_after} (suspicion precedes "
                f"death) or None to disable the kill escalation")
        if self.wall_slow_factor <= 1.0:
            raise ValueError(f"wall_slow_factor must be > 1.0, "
                             f"got {self.wall_slow_factor}")
        if self.wall_window < 4:
            raise ValueError(f"wall_window must be >= 4, "
                             f"got {self.wall_window}")


class FailureDetector:
    """Per-lane healthy/suspected/dead state machine (host-side).

    Args:
      n_lanes: number of lanes (replicas) tracked.
      policy: the shared :class:`DetectorPolicy` (default-constructed
        when omitted).
      on_suspect / on_dead / on_revive: escalation callbacks, each
        ``(lane: int) -> None``; see the module docstring for when they
        fire.  All optional — an unwired detector is a pure classifier.
    """

    def __init__(self, n_lanes: int, policy: Optional[DetectorPolicy] = None,
                 *, on_suspect: Optional[Callable[[int], None]] = None,
                 on_dead: Optional[Callable[[int], None]] = None,
                 on_revive: Optional[Callable[[int], None]] = None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self.n_lanes = int(n_lanes)
        self.policy = policy or DetectorPolicy()
        self.on_suspect = on_suspect
        self.on_dead = on_dead
        self.on_revive = on_revive
        self._state: List[str] = [HEALTHY] * self.n_lanes
        self._slow_streak = [0] * self.n_lanes
        self._fast_streak = [0] * self.n_lanes
        # Per-lane rolling wall-clock history for observe_wall (bounded;
        # allocated eagerly — it's W deques of <= wall_window floats).
        self._wall_hist = [collections.deque(maxlen=self.policy.wall_window)
                           for _ in range(self.n_lanes)]

    # -- observations --------------------------------------------------------

    def observe(self, lane: int, slow: bool) -> str:
        """Feed one observation for ``lane``; returns its (new) state.

        A DEAD lane short-circuits: corpses produce no meaningful
        heartbeats, and their state only changes through
        :meth:`revive`."""
        return self._observe(lane, slow, allow_kill=True)

    def observe_wall(self, lane: int, wall_s: float) -> str:
        """Feed one REAL wall-clock observation (seconds) for ``lane``;
        returns its (new) state.

        The observation is classified against the lane's own rolling
        baseline — the median of its last ``wall_window`` observations —
        as ``slow = wall_s > wall_slow_factor * baseline``, then runs the
        same streak machine as :meth:`observe`, except that wall-driven
        streaks stop at SUSPECTED unless ``policy.wall_kill`` (the wall
        of one SPMD dispatch is a collective signal: it says "this round
        ran slow", not "this lane is at fault", so by default it boosts
        the steal proportion but never kills).  The sample is appended to
        the history AFTER classification (a spike judges against clean
        history; the median keeps later baselines robust to <50 %
        outliers), and no lane is judged before ``max(4,
        wall_window // 4)`` samples exist."""
        self._check_lane(lane)
        if self._state[lane] == DEAD:
            return DEAD
        pol = self.policy
        hist = self._wall_hist[lane]
        min_samples = max(4, pol.wall_window // 4)
        slow = False
        if len(hist) >= min_samples:
            baseline = statistics.median(hist)
            slow = wall_s > pol.wall_slow_factor * baseline
        hist.append(float(wall_s))
        return self._observe(lane, slow, allow_kill=pol.wall_kill)

    def _observe(self, lane: int, slow: bool, *, allow_kill: bool) -> str:
        self._check_lane(lane)
        if self._state[lane] == DEAD:
            return DEAD
        pol = self.policy
        if slow:
            self._slow_streak[lane] += 1
            self._fast_streak[lane] = 0
            streak = self._slow_streak[lane]
            if (allow_kill and pol.dead_after is not None
                    and streak >= pol.dead_after):
                self._state[lane] = DEAD
                if self.on_dead is not None:
                    self.on_dead(lane)
            elif streak >= pol.suspect_after:
                self._state[lane] = SUSPECTED
                # Re-fired on every slow observation past the threshold,
                # so the owner's temporary boost tracks the lag window.
                if self.on_suspect is not None:
                    self.on_suspect(lane)
        else:
            self._fast_streak[lane] += 1
            self._slow_streak[lane] = 0
            if (self._state[lane] == SUSPECTED
                    and self._fast_streak[lane] >= pol.healthy_after):
                self._state[lane] = HEALTHY
        return self._state[lane]

    def revive(self, lane: int) -> None:
        """Clear ``lane`` back to HEALTHY with zeroed streaks (grow,
        re-admission, or the runtime's ``revive_lane``)."""
        self._check_lane(lane)
        was_dead = self._state[lane] == DEAD
        self._state[lane] = HEALTHY
        self._slow_streak[lane] = 0
        self._fast_streak[lane] = 0
        self._wall_hist[lane].clear()
        if was_dead and self.on_revive is not None:
            self.on_revive(lane)

    # -- inspection ----------------------------------------------------------

    def state(self, lane: int) -> str:
        self._check_lane(lane)
        return self._state[lane]

    def states(self) -> List[str]:
        return list(self._state)

    def streak(self, lane: int) -> int:
        """The lane's current consecutive-slow count."""
        self._check_lane(lane)
        return self._slow_streak[lane]

    def _check_lane(self, lane: int) -> None:
        if not (0 <= lane < self.n_lanes):
            raise ValueError(f"lane {lane} out of range [0, {self.n_lanes})")
