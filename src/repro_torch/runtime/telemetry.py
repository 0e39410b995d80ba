"""Per-round and per-wave observability (PyTorch port of
``repro.runtime.telemetry``).

Host-side and numpy-only: each rebalancing round appends one
:class:`RoundRecord` with the steal count, items and bytes moved, the
exchange payload (``bytes_moved``), the queue-depth histogram and the
imbalance.  Wave-level consumers (the serving engine) append
:class:`WaveRecord` entries through the same object, request timelines
land as :class:`RequestRecord` s, and fault / detector transitions as
counters (:attr:`Telemetry.fault_events`) and a round-stamped log
(:attr:`Telemetry.fault_log`).  ``summary()`` collapses the log into the
aggregates, with the JAX package's keys:

* ``rounds`` / ``steals`` / ``items_transferred`` /
  ``bytes_transferred`` / ``bytes_moved`` — lifetime round totals;
* ``proportion_mean`` / ``proportion_final`` / ``imbalance_final``;
* ``waves`` / ``served`` / ``tokens`` (and ``migrated`` when nonzero) —
  only when wave records exist;
* ``requests`` + ``ttft_p50/p95/p99`` + ``latency_p50/p95/p99`` (in
  logical rounds) — only when request records exist;
* ``straggler_steps`` always, ``faults`` when any were recorded.

The JAX package's phase-probe fields (``t_*`` on ``RoundRecord``,
``phase_summary``) wait for the observability slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["reduce_round_stats", "RoundRecord", "WaveRecord",
           "RequestRecord", "Telemetry"]


def reduce_round_stats(stats) -> tuple:
    """Exact ``(n_steals, n_transferred, bytes_moved)`` of one round from a
    ``RebalanceStats`` with host (numpy) leaves.  Flat mode: the counters
    are one value for all lanes (element 0 if a per-lane copy is given)."""
    return tuple(int(np.asarray(x).reshape(-1)[0])
                 for x in (stats.n_steals, stats.n_transferred,
                           stats.bytes_moved))


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One rebalancing round, as observed by the master."""

    round: int
    proportion: float          # steal proportion used THIS round
    n_steals: int              # victim->thief transfers planned
    n_transferred: int         # items moved
    transfer_bytes: int        # payload bytes moved
    bytes_moved: int           # exchange payload, one lane's view
    sizes_total: int
    sizes_max: int
    sizes_mean: float
    depth_hist: Sequence[int]  # queue-depth histogram over workers

    @property
    def imbalance(self) -> float:
        """max/mean load ratio (1.0 = perfectly balanced)."""
        return self.sizes_max / self.sizes_mean if self.sizes_mean else 0.0


@dataclasses.dataclass(frozen=True)
class WaveRecord:
    """One workload wave (a serving engine tick), as observed by whoever
    drives the rounds — same stream, coarser granularity.

    The SLO fields are percentiles over every :class:`RequestRecord`
    completed up to and including this wave (in logical rounds), filled in
    by :meth:`Telemetry.record_wave` whenever request records exist."""

    wave: int
    served: int                # requests completed this wave
    tokens: int                # tokens generated this wave (0 if n/a)
    loads: Sequence[int]       # per-worker load after the wave
    evicted: int = 0           # workers evicted (cumulative) at this wave
    stragglers: int = 0        # straggler flags raised this wave
    migrated: int = 0          # in-flight requests migrated (KV and all)
    ttft_p50: float = 0.0      # admit -> first-token percentiles (rounds)
    ttft_p95: float = 0.0
    ttft_p99: float = 0.0
    latency_p50: float = 0.0   # admit -> finish percentiles (rounds)
    latency_p95: float = 0.0
    latency_p99: float = 0.0
    round: int = -1            # logical round the wave closed at


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One served request's admit -> first-token -> finish timeline,
    stamped in LOGICAL rounds."""

    rid: int
    admit: int                 # round the request was admitted
    first: int                 # round the first token was generated
    finish: int                # round the last token was generated
    tokens: int                # tokens actually generated

    @property
    def ttft(self) -> int:
        """Time-to-first-token, in rounds."""
        return self.first - self.admit

    @property
    def latency(self) -> int:
        """Admit-to-finish latency, in rounds."""
        return self.finish - self.admit


def _percentiles(values) -> tuple:
    """(p50, p95, p99) of a non-empty value sequence."""
    arr = np.asarray(values, np.float64)
    return tuple(float(np.percentile(arr, p)) for p in (50.0, 95.0, 99.0))


def _slo(requests) -> Dict[str, float]:
    t50, t95, t99 = _percentiles([r.ttft for r in requests])
    l50, l95, l99 = _percentiles([r.latency for r in requests])
    return dict(ttft_p50=t50, ttft_p95=t95, ttft_p99=t99,
                latency_p50=l50, latency_p95=l95, latency_p99=l99)


class Telemetry:
    """Append-only per-round log + aggregate summary."""

    def __init__(self, item_bytes: int = 1, capacity: Optional[int] = None,
                 n_bins: int = 8):
        self.item_bytes = int(item_bytes)
        self.capacity = capacity
        self.n_bins = n_bins
        self.rounds: List[RoundRecord] = []
        self.waves: List[WaveRecord] = []
        self.requests: List[RequestRecord] = []
        # Event counters (evictions, straggler flags, ...) and the
        # round-stamped log: (kind, lane, round) per record_fault call
        # (lane -1 = not lane-attributed).
        self.fault_events: Dict[str, int] = {}
        self.fault_log: List[tuple] = []
        self.straggler_steps = 0

    def record(self, *, sizes, n_steals: int, n_transferred: int,
               proportion: float, bytes_moved: int = 0) -> RoundRecord:
        """Append one round."""
        sizes = np.asarray(sizes)
        hi = self.capacity if self.capacity else max(int(sizes.max()), 1)
        hist, _ = np.histogram(sizes, bins=self.n_bins, range=(0, hi))
        rec = RoundRecord(
            round=len(self.rounds),
            proportion=float(proportion),
            n_steals=int(n_steals),
            n_transferred=int(n_transferred),
            transfer_bytes=int(n_transferred) * self.item_bytes,
            bytes_moved=int(bytes_moved),
            sizes_total=int(sizes.sum()),
            sizes_max=int(sizes.max()) if sizes.size else 0,
            sizes_mean=float(sizes.mean()) if sizes.size else 0.0,
            depth_hist=tuple(int(x) for x in hist),
        )
        self.rounds.append(rec)
        return rec

    def record_wave(self, *, loads, served: int, tokens: int = 0,
                    evicted: int = 0, stragglers: int = 0,
                    migrated: int = 0) -> WaveRecord:
        """Append one workload wave.  When request records exist
        (:meth:`record_request`), the wave carries the cumulative SLO
        percentiles at this point in time."""
        slo = _slo(self.requests) if self.requests else {}
        rec = WaveRecord(
            wave=len(self.waves),
            served=int(served),
            tokens=int(tokens),
            loads=tuple(int(x) for x in np.asarray(loads).reshape(-1)),
            evicted=int(evicted),
            stragglers=int(stragglers),
            migrated=int(migrated),
            round=len(self.rounds),
            **slo,
        )
        self.waves.append(rec)
        return rec

    def record_request(self, *, rid: int, admit: int, first: int,
                       finish: int, tokens: int) -> RequestRecord:
        """Append one served request's admit/first-token/finish stamps
        (logical rounds)."""
        rec = RequestRecord(rid=int(rid), admit=int(admit), first=int(first),
                            finish=int(finish), tokens=int(tokens))
        self.requests.append(rec)
        return rec

    def record_fault(self, kind: str, n: int = 1,
                     lane: Optional[int] = None) -> None:
        """Count one event (``"evict"`` / ``"readmit"`` / ``"straggler"``
        / ``"auto_evict"`` / ...), stamped with the current round count in
        :attr:`fault_log`.  Straggler flags also feed
        :attr:`straggler_steps`."""
        self.fault_events[kind] = self.fault_events.get(kind, 0) + int(n)
        self.fault_log.append((kind, -1 if lane is None else int(lane),
                               len(self.rounds)))
        if kind == "straggler":
            self.straggler_steps += int(n)

    @property
    def total_steals(self) -> int:
        return sum(r.n_steals for r in self.rounds)

    @property
    def total_transferred(self) -> int:
        return sum(r.n_transferred for r in self.rounds)

    @property
    def total_transfer_bytes(self) -> int:
        return sum(r.transfer_bytes for r in self.rounds)

    @property
    def total_bytes_moved(self) -> int:
        """Total per-lane exchange payload across rounds."""
        return sum(r.bytes_moved for r in self.rounds)

    @property
    def total_served(self) -> int:
        return sum(w.served for w in self.waves)

    @property
    def total_tokens(self) -> int:
        return sum(w.tokens for w in self.waves)

    def summary(self) -> Dict[str, Any]:
        props = [r.proportion for r in self.rounds]
        out = {
            "rounds": len(self.rounds),
            "steals": self.total_steals,
            "items_transferred": self.total_transferred,
            "bytes_transferred": self.total_transfer_bytes,
            "bytes_moved": self.total_bytes_moved,
            "proportion_mean": float(np.mean(props)) if props else 0.0,
            "proportion_final": props[-1] if props else 0.0,
            "imbalance_final": self.rounds[-1].imbalance if self.rounds
            else 0.0,
        }
        if self.waves:
            out["waves"] = len(self.waves)
            out["served"] = self.total_served
            out["tokens"] = self.total_tokens
            migrated = sum(w.migrated for w in self.waves)
            if migrated:
                out["migrated"] = migrated
        if self.requests:
            out["requests"] = len(self.requests)
            out.update(_slo(self.requests))
        out["straggler_steps"] = self.straggler_steps
        if self.fault_events:
            out["faults"] = dict(self.fault_events)
        return out
