"""Runtime sanitizer: every queue op validated against its contract
(PyTorch port of ``repro.analysis.sanitize``).

``REPRO_CHECK=1`` (or ``make_ops(..., check=True)``) makes
:func:`repro_torch.core.ops.make_ops` wrap whatever backend it resolves
in a :class:`CheckedBulkOps`.  The wrapper delegates the work to the
wrapped backend unchanged and holds each result to the sequential
contract that :mod:`repro_torch.analysis.linearize` checks exhaustively
on small rings.

The port has no trace: every state is concrete, so every op gets the
FULL check, lane by lane (a state is one queue or W stacked lanes) —
the count's clamp arithmetic (the steal plan in float32, as the op
computes it, and the :meth:`~repro_torch.core.ops.BulkOps.gated` flag
applied), the cursor moves (``lo' == (lo + n) % cap`` on the steal side,
``lo`` frozen on the owner side), exact content conservation (the rows
an op hands out are exactly the right slice of the lane's live region,
and what stays is unchanged) and dead batch rows zeroed.  Ops with
``donate=True`` write the ring in place, so the "before" snapshot (the
cursors and the rings, copied to the host) is taken before the call.
Every check reads back, so the sanitizer is off unless asked for.

Outside a round a violation raises :class:`SanitizerError` at once,
naming the op.  Inside :meth:`StealRuntime.round` and
:meth:`StealRuntime.run_fused` (:func:`deferred`) violations are
recorded, and the executor raises at the block's read-back
(:func:`raise_pending`), with two cross-op checks of its own: each
round's size vector must keep its sum, and a rebalancing round with no
worker body must keep the multiset of live items across all lanes
(:func:`queues_fingerprint`), the paper's tagged-item conservation on
real payload bytes.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.core import ops as bulk_ops
from repro_torch.core.ops import QueueState, to_numpy

__all__ = [
    "CheckedBulkOps",
    "SanitizerError",
    "checking_enabled",
    "violations",
    "reset_violations",
    "assert_clean",
    "raise_pending",
    "record_violation",
    "deferred",
    "check_round_stats",
    "trace_check_superstep",
    "queues_fingerprint",
    "check_conserved",
]

Pytree = Any


class SanitizerError(AssertionError):
    """A queue-op invariant did not hold at runtime."""


_VIOLATIONS: List[str] = []
_DEFERRED = [0]  # depth of open deferred() blocks


def checking_enabled() -> bool:
    """Whether ``REPRO_CHECK`` asks for the sanitizer (the same switch
    :func:`repro_torch.core.ops.make_ops` consults)."""
    return bulk_ops._env_check()


def violations() -> Tuple[str, ...]:
    return tuple(_VIOLATIONS)


def reset_violations() -> None:
    _VIOLATIONS.clear()


def record_violation(msg: str, *, eager: bool = False) -> None:
    """Log one violation.  ``eager=True`` (an op's own check) raises at
    once, unless a :func:`deferred` block is open; the others only
    record, and a checkpoint raises."""
    _VIOLATIONS.append(msg)
    if eager and not _DEFERRED[0]:
        raise SanitizerError(msg)


@contextlib.contextmanager
def deferred():
    """Within the block, op violations are recorded, not raised: the
    executor's rounds, which raise at their read-back."""
    _DEFERRED[0] += 1
    try:
        yield
    finally:
        _DEFERRED[0] -= 1


def raise_pending(context: str) -> None:
    """Raise (and clear) any violations recorded since the last
    checkpoint."""
    if _VIOLATIONS:
        msgs = list(_VIOLATIONS)
        _VIOLATIONS.clear()
        raise SanitizerError(
            f"{len(msgs)} invariant violation(s) at {context}:\n  "
            + "\n  ".join(msgs))


def assert_clean() -> None:
    """Final checkpoint: raise if anything was recorded, else no-op."""
    raise_pending("assert_clean")


# ---------------------------------------------------------------------------
# Host snapshots of states, batches and counts
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy that no later in-place write can reach."""
    return np.array(to_numpy(t), copy=True)


class _Snap(NamedTuple):
    """Host copy of a state as stacked lanes."""

    lo: np.ndarray          # (W,) int64
    size: np.ndarray        # (W,) int64
    leaves: List[np.ndarray]  # (W, cap, ...)

    @property
    def cap(self) -> int:
        return self.leaves[0].shape[1]

    def live(self, w: int) -> List[np.ndarray]:
        """Lane ``w``'s live rows per leaf, oldest first."""
        idx = (int(self.lo[w]) + np.arange(max(int(self.size[w]), 0))) \
            % self.cap
        return [leaf[w][idx] for leaf in self.leaves]


def _snapshot(q: QueueState) -> _Snap:
    single = q.lo.dim() == 0
    lead = (lambda a: a[None]) if single else (lambda a: a)
    return _Snap(lo=lead(_host(q.lo)).astype(np.int64).reshape(-1),
                 size=lead(_host(q.size)).astype(np.int64).reshape(-1),
                 leaves=[lead(_host(b)) for b in tree_leaves(q.buf)])


def _lane_rows(tree: Pytree, single: bool) -> List[np.ndarray]:
    """Host copies of a batch's leaves with the lane dimension first."""
    return [(lambda a: a[None] if single else a)(_host(x))
            for x in tree_leaves(tree)]


def _per_lane(x, w: int) -> np.ndarray:
    """A count (int, 0-d or per-lane tensor) as ``(w,)`` int64, the way
    the ops broadcast it (``ops._count``)."""
    if isinstance(x, torch.Tensor):
        a = _host(x.to(torch.int32)).astype(np.int64).reshape(-1)
        return np.broadcast_to(a, (w,)) if a.size == 1 else a.reshape(w)
    return np.full((w,), int(x), np.int64)


def _rows_equal(a: Sequence[np.ndarray], b: Sequence[np.ndarray]) -> bool:
    return (len(a) == len(b)
            and all(x.shape == y.shape and np.array_equal(x, y)
                    for x, y in zip(a, b)))


def _concat(a: Sequence[np.ndarray], b: Sequence[np.ndarray]
            ) -> List[np.ndarray]:
    return [np.concatenate([x, y], axis=0) for x, y in zip(a, b)]


def _mirror_steal_plan(size: int, proportion, queue_limit: int,
                       max_steal: int, donate: bool = False) -> int:
    """Host mirror of ``ops._steal_plan``'s float32 arithmetic:
    ``floor(float32(size) * (1 - p))`` stay, never in float64 (the
    relaxed claim settles to the same count).  With ``donate`` a Python
    float is rounded to float32 before the subtraction, as the op does."""
    if isinstance(proportion, (int, float)) and donate:
        proportion = np.float32(proportion)
    if isinstance(proportion, (int, float)):
        mult = np.float32(1.0 - float(proportion))
    else:  # a float32 tensor: subtract in float32 like the op
        p = proportion.detach().cpu().numpy() if isinstance(
            proportion, torch.Tensor) else np.asarray(proportion)
        mult = np.float32(1.0) - np.float32(p)
    keep = int(np.floor(np.float32(size) * mult))
    n = int(np.clip(size - keep, 0, min(size, max_steal)))
    return 0 if size < queue_limit else n


# ---------------------------------------------------------------------------
# The checked backend wrapper
# ---------------------------------------------------------------------------


class CheckedBulkOps(bulk_ops.BulkOps):
    """Delegating wrapper: same :class:`~repro_torch.core.ops.BulkOps`
    surface, same results, every call validated lane by lane (see the
    module docstring).  Obtain via ``make_ops(..., check=True)`` or
    ``REPRO_CHECK=1``."""

    checked = True

    def __init__(self, inner: bulk_ops.BulkOps):
        super().__init__(inner.name, kernel=inner.kernel)
        self.inner = inner

    @property
    def resolved(self) -> str:
        return self.inner.resolved

    def __repr__(self) -> str:
        return f"CheckedBulkOps({self.inner!r})"

    def __getattr__(self, name: str):
        # Backend extras (e.g. RelaxedBulkOps.multiplicity_bound) pass
        # through; only called for attributes not found normally.
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @contextlib.contextmanager
    def gated(self, active: torch.Tensor):
        """The gate reaches the wrapped backend, and the expected counts
        apply it."""
        with self.inner.gated(active), super().gated(active):
            yield self

    def _gate_on(self) -> int:
        return 1 if self._gate is None else int(bool(self._gate))

    @staticmethod
    def _bad(op: str, w: int, msg: str) -> None:
        record_violation(f"{op}: {msg} (lane {w})", eager=True)

    # -- ops -----------------------------------------------------------------

    def push(self, q, batch, n, *, donate: bool = False):
        single = q.lo.dim() == 0
        b = _snapshot(q)  # before the (possibly in-place) op
        w_n, cap, g = len(b.lo), b.cap, self._gate_on()
        n_req = _per_lane(n, w_n)
        rows = _lane_rows(batch, single)
        q2, n_pushed = self.inner.push(q, batch, n, donate=donate)
        got, a = _per_lane(n_pushed, w_n), _snapshot(q2)
        for w in range(w_n):
            exp = max(min(int(n_req[w]), cap - int(b.size[w])), 0) * g
            if got[w] != exp:
                self._bad("push", w, f"n_pushed={got[w]}, expected clamp "
                          f"min(n={n_req[w]}, space={cap - b.size[w]}) = "
                          f"{exp}")
            if exp > rows[0].shape[1]:
                self._bad("push", w, f"n={n_req[w]} settled at {exp} > "
                          f"batch rows {rows[0].shape[1]}: garbage rows "
                          f"became live (caller contract: n <= B)")
            self._owner_cursor("push", w, b, a, int(b.size[w]) + exp)
            if not _rows_equal(a.live(w), _concat(
                    b.live(w), [r[w][:exp] for r in rows])):
                self._bad("push", w, "live region != old live ++ "
                          "batch[:n]")
        return q2, n_pushed

    def pop(self, q, *, donate: bool = False):
        single = q.lo.dim() == 0
        b = _snapshot(q)
        w_n, g = len(b.lo), self._gate_on()
        q2, item, valid = self.inner.pop(q, donate=donate)
        ok, a = _per_lane(valid, w_n), _snapshot(q2)
        items = _lane_rows(item, single)
        for w in range(w_n):
            exp = int(b.size[w] > 0) * g
            if ok[w] != exp:
                self._bad("pop", w, f"valid={bool(ok[w])} on size="
                          f"{b.size[w]}")
            self._owner_cursor("pop", w, b, a, int(b.size[w]) - exp)
            live = b.live(w)
            if exp and not _rows_equal([r[w][None] for r in items],
                                       [r[-1:] for r in live]):
                self._bad("pop", w, "item != newest live row")
            if not _rows_equal(a.live(w),
                               [r[:len(r) - exp] for r in live]):
                self._bad("pop", w, "surviving live region changed")
        return q2, item, valid

    def pop_bulk(self, q, max_n: int, n, *, donate: bool = False):
        single = q.lo.dim() == 0
        b = _snapshot(q)
        w_n, g = len(b.lo), self._gate_on()
        n_req = _per_lane(n, w_n)
        q2, batch, n_popped = self.inner.pop_bulk(q, max_n, n, donate=donate)
        got, a = _per_lane(n_popped, w_n), _snapshot(q2)
        rows = _lane_rows(batch, single)
        for w in range(w_n):
            size = int(b.size[w])
            exp = max(min(int(n_req[w]), size, max_n), 0) * g
            if got[w] != exp:
                self._bad("pop_bulk", w, f"n_popped={got[w]}, expected "
                          f"min(n={n_req[w]}, size={size}, max_n={max_n})"
                          f" = {exp}")
            self._owner_cursor("pop_bulk", w, b, a, size - exp)
            live = b.live(w)
            self._block_out("pop_bulk", w, rows, exp,
                            [r[size - exp:] for r in live])
            if not _rows_equal(a.live(w), [r[:size - exp] for r in live]):
                self._bad("pop_bulk", w, "surviving live region changed")
        return q2, batch, n_popped

    def steal(self, q, proportion, *, max_steal: int,
              queue_limit: int = bulk_ops.DEFAULT_QUEUE_LIMIT,
              donate: bool = False):
        b = _snapshot(q)
        g = self._gate_on()
        exp = [_mirror_steal_plan(int(s), proportion, queue_limit,
                                  max_steal, donate) * g for s in b.size]
        q2, batch, n = self.inner.steal(q, proportion, max_steal=max_steal,
                                        queue_limit=queue_limit,
                                        donate=donate)
        self._steal_checks("steal", q2, batch, n, exp, b)
        return q2, batch, n

    def steal_exact(self, q, n, *, max_steal: int, donate: bool = False):
        b = _snapshot(q)
        g = self._gate_on()
        n_req = _per_lane(n, len(b.lo))
        exp = [int(np.clip(r, 0, min(int(s), max_steal))) * g
               for r, s in zip(n_req, b.size)]
        q2, batch, n_out = self.inner.steal_exact(q, n, max_steal=max_steal,
                                                  donate=donate)
        self._steal_checks("steal_exact", q2, batch, n_out, exp, b)
        return q2, batch, n_out

    def window(self, q, *, max_steal: int, donate: bool = False):
        single = q.lo.dim() == 0
        b = _snapshot(q)
        window = self.inner.window(q, max_steal=max_steal, donate=donate)
        rows = _lane_rows(window, single)
        for w in range(len(b.lo)):
            k = min(int(b.size[w]), max_steal)
            if not _rows_equal([r[w][:k] for r in rows],
                               [r[:k] for r in b.live(w)]):
                self._bad("window", w, "live prefix != the lane's oldest "
                          "rows")
        return window

    def transfer(self, q, gathered, src_row, n, *, max_steal: int,
                 donate: bool = False):
        b = _snapshot(q)
        w_n, cap, g = len(b.lo), b.cap, self._gate_on()
        n_req, src = _per_lane(n, w_n), _per_lane(src_row, w_n)
        stack = [_host(x) for x in tree_leaves(gathered)]
        rows_src = stack[0].shape[0]
        q2, n_out = self.inner.transfer(q, gathered, src_row, n,
                                        max_steal=max_steal, donate=donate)
        got, a = _per_lane(n_out, w_n), _snapshot(q2)
        for w in range(w_n):
            exp = max(min(int(n_req[w]), cap - int(b.size[w]), max_steal),
                      0) * g
            if got[w] != exp:
                self._bad("transfer", w, f"n_spliced={got[w]}, expected "
                          f"min(n={n_req[w]}, space={cap - b.size[w]}, "
                          f"max_steal={max_steal}) = {exp}")
            self._owner_cursor("transfer", w, b, a, int(b.size[w]) + exp)
            row = int(np.clip(src[w], -rows_src, rows_src - 1))
            if not _rows_equal(a.live(w), _concat(
                    b.live(w), [s[row][:exp] for s in stack])):
                self._bad("transfer", w, "live region != old live ++ "
                          "gathered[src_row, :n]")
        return q2, n_out

    # -- shared assertions ---------------------------------------------------

    def _owner_cursor(self, op: str, w: int, b: _Snap, a: _Snap,
                      size_exp: int) -> None:
        if a.lo[w] != b.lo[w]:
            self._bad(op, w, f"owner op moved the steal cursor "
                      f"({b.lo[w]} -> {a.lo[w]})")
        if a.size[w] != size_exp:
            self._bad(op, w, f"size {a.size[w]} != {size_exp}")

    def _block_out(self, op: str, w: int, rows: List[np.ndarray], n: int,
                   want: List[np.ndarray]) -> None:
        if not _rows_equal([r[w][:n] for r in rows], want):
            self._bad(op, w, "batch[:n] != the detached live block")
        if any(np.any(r[w][n:]) for r in rows):
            self._bad(op, w, "rows >= n not zeroed (dead rows must be "
                      "exchange-safe)")

    def _steal_checks(self, op: str, q2, batch, n, exp: List[int],
                      b: _Snap) -> None:
        w_n, cap = len(b.lo), b.cap
        got, a = _per_lane(n, w_n), _snapshot(q2)
        rows = _lane_rows(batch, q2.lo.dim() == 0)
        for w in range(w_n):
            if got[w] != exp[w]:
                self._bad(op, w, f"n_stolen={got[w]}, expected {exp[w]}")
            if a.lo[w] != (b.lo[w] + exp[w]) % cap:
                self._bad(op, w, f"cursor lo {b.lo[w]} -> {a.lo[w]}, "
                          f"expected (lo + {exp[w]}) % {cap}")
            if a.size[w] != b.size[w] - exp[w]:
                self._bad(op, w, f"size {b.size[w]} -> {a.size[w]} != "
                          f"size - n")
            live = b.live(w)
            self._block_out(op, w, rows, exp[w], [r[:exp[w]] for r in live])
            if not _rows_equal(a.live(w), [r[exp[w]:] for r in live]):
                self._bad(op, w, "surviving live region changed")


# ---------------------------------------------------------------------------
# Executor-level checks (host side, after read-back)
# ---------------------------------------------------------------------------


def trace_check_superstep(sizes_before, sizes_after, *,
                          capacity: int) -> None:
    """Conservation of one superstep: the ``(W,)`` size vectors before
    and after must have equal sums and stay in ``[0, capacity]``.  Called
    by ``master.superstep`` when ``REPRO_CHECK`` is on; records, never
    raises (the executor's read-back or :func:`assert_clean` does)."""
    b = _host(sizes_before).astype(np.int64).reshape(-1)
    a = _host(sizes_after).astype(np.int64).reshape(-1)
    if b.sum() != a.sum():
        record_violation(f"superstep: sum(sizes) not conserved "
                         f"({int(b.sum())} -> {int(a.sum())})")
    if np.any((a < 0) | (a > capacity)):
        record_violation(f"superstep: sizes_after outside [0, {capacity}]")


def check_round_stats(stats, *, n_workers: int, capacity: int,
                      context: str = "round") -> None:
    """Validate one round's :class:`~repro_torch.core.master.RebalanceStats`
    after the host read-back: the ``(W,)`` size vectors keep their sum and
    stay in bounds, and the counters are non-negative."""
    if (np.any(np.asarray(stats.n_steals) < 0)
            or np.any(np.asarray(stats.n_transferred) < 0)):
        record_violation(f"{context}: negative steal/transfer counters")
    b = np.asarray(stats.sizes_before, np.int64).reshape(-1, n_workers)[0]
    a = np.asarray(stats.sizes_after, np.int64).reshape(-1, n_workers)[0]
    if b.sum() != a.sum():
        record_violation(f"{context}: superstep lost items — sum(sizes) "
                         f"{int(b.sum())} -> {int(a.sum())}")
    if np.any((a < 0) | (a > capacity)) or np.any((b < 0) | (b > capacity)):
        record_violation(f"{context}: sizes outside [0, {capacity}]")


def _sorted_rows(a: np.ndarray) -> np.ndarray:
    flat = np.ascontiguousarray(a.reshape(a.shape[0], -1))
    if flat.shape[0] == 0:
        return flat
    return flat[np.lexsort(flat.T[::-1])]


def queues_fingerprint(queues: QueueState) -> List[np.ndarray]:
    """Order-independent multiset fingerprint of every live item across
    stacked lanes: per payload leaf, the live rows of all lanes together,
    sorted lexicographically.  Two fingerprints are equal iff the
    live-item multisets are."""
    snap = _snapshot(queues)
    out: List[np.ndarray] = []
    for i in range(len(snap.leaves)):
        rows = [snap.live(w)[i] for w in range(len(snap.lo))]
        out.append(_sorted_rows(np.concatenate(rows, axis=0)))
    return out


def check_conserved(before: List[np.ndarray], after: List[np.ndarray],
                    *, context: str) -> None:
    """Compare two :func:`queues_fingerprint` snapshots: a pure
    rebalancing round must preserve the live-item multiset exactly."""
    for i, (b, a) in enumerate(zip(before, after)):
        if b.shape != a.shape:
            record_violation(
                f"{context}: live-item count changed on leaf {i} "
                f"({b.shape[0]} -> {a.shape[0]} rows)")
        elif not np.array_equal(b, a):
            record_violation(
                f"{context}: live-item multiset changed on leaf {i} "
                f"(items duplicated or replaced)")
