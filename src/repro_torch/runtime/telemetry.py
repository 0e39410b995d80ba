"""Per-round observability for the steal runtime (PyTorch port of the
round part of ``repro.runtime.telemetry``).

Host-side and numpy-only: each rebalancing round appends one
:class:`RoundRecord` with the steal count, items and bytes moved, the
exchange payload (``bytes_moved``), the queue-depth histogram and the
imbalance; ``summary()`` collapses the log into the aggregates the solver
reports.  The JAX package's wave, request, fault and phase records wait
for the slices that port serving, resilience and the phase probe.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["reduce_round_stats", "RoundRecord", "Telemetry"]


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


class Telemetry:
    """Append-only per-round log + aggregate summary."""

    def __init__(self, item_bytes: int = 1, capacity: Optional[int] = None,
                 n_bins: int = 8):
        self.item_bytes = int(item_bytes)
        self.capacity = capacity
        self.n_bins = n_bins
        self.rounds: List[RoundRecord] = []

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

    def summary(self) -> Dict[str, Any]:
        props = [r.proportion for r in self.rounds]
        return {
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
