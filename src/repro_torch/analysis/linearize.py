"""Linearizability model checker for the bulk work-stealing queue
(PyTorch port of ``repro.analysis.linearize``).

The paper argues informally that every operation linearizes at one
cursor write (``size += n`` for the owner, ``lo += n`` for the stealer).
This module checks it EXHAUSTIVELY on small rings:

* the **shared object** is a real :class:`~repro_torch.core.ops.QueueState`
  on ``device`` driven through a real backend (``reference`` / ``cuda`` /
  ``auto`` / ``relaxed``; on the card the kernel routings launch K1-K4,
  on the CPU every kernel wrapper runs its plain version);
* the **threads** are one owner (``push`` / ``pop`` / ``pop_bulk``) and
  one stealer (``steal`` / ``steal_exact``), the paper's model.  Items
  carry unique int32 ids (0 is the dead-row filler), so conservation is
  checked on identity, not counts;
* the **histories** are every interleaving of an owner script and a
  stealer script, from seeded initial states including wrapped cursors;
* the **oracle** is :class:`SeqSpec`, a Python list mirroring the clamp
  arithmetic of ``core/ops.py`` (the float32 ``floor(size * (1 - p))``
  of the steal plan included).

Fenced backends: every step is atomic, and each op's count, batch and
state must equal the sequential spec's (exact linearizability).

``relaxed``: each steal is two steps,
:func:`~repro_torch.core.relaxed.optimistic_read` then
:func:`~repro_torch.core.relaxed.reconcile`, and owner steps may land
between them.  The checker holds it to the weaker contract: ``size``
never negative and the cursor bumped by exactly the settled count; the
transient over-claim within ``multiplicity_bound(max_steal)``; no item
lost and none beyond the bound, over (escaped + live) at the end; and
the settle equal to a fenced ``steal_exact`` of the settled count against
the owner's CURRENT state.  The deliberately broken reconciles of
:data:`MUTATIONS` (no floor clamp, no size clamp) show that the checker
can fail: ``--mutate`` exits non-zero unless each is caught.

The scripts below give 330 histories per fenced backend and 636 for the
split relaxed backend on each geometry, (4, 2) and (8, 4)
(:data:`FENCED_HISTORIES`, :data:`SPLIT_HISTORIES`; the JAX package's
``check_backend`` enumerates the same).

CLI (CUDA unless ``--device cpu``)::

    python -m repro_torch.analysis.linearize            # all backends
    python -m repro_torch.analysis.linearize --quick    # (4, 2) only
    python -m repro_torch.analysis.linearize --mutate   # must-catch bugs
"""

from __future__ import annotations

import argparse
import itertools
import sys
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import resolve_device
from repro_torch.analysis.sanitize import _mirror_steal_plan
from repro_torch.core import ops as bulk_ops
from repro_torch.core import relaxed as relaxed_mod
from repro_torch.core.ops import QueueState

__all__ = ["SeqSpec", "check_backend", "check_all", "run_mutations",
           "MUTATIONS", "FENCED_BACKENDS", "ALL_BACKENDS",
           "FENCED_HISTORIES", "SPLIT_HISTORIES", "expected_histories"]

FENCED_BACKENDS = ("reference", "cuda", "auto")
ALL_BACKENDS = FENCED_BACKENDS + ("relaxed",)
QUEUE_LIMIT = 0  # scripts drive tiny queues; no abort threshold noise

# Histories per backend and geometry, (4, 2) and (8, 4) alike: 3 initial
# states x sum over (owner, stealer) scripts of C(owner + stealer steps,
# owner steps), a split steal counting two stealer steps.
FENCED_HISTORIES = 330
SPLIT_HISTORIES = 636


def expected_histories(backend: str) -> int:
    return SPLIT_HISTORIES if backend == "relaxed" else FENCED_HISTORIES


# ---------------------------------------------------------------------------
# The sequential specification
# ---------------------------------------------------------------------------


class SeqSpec:
    """The sequential queue: a Python list, oldest first, mirroring the
    ops' clamp arithmetic exactly."""

    def __init__(self, capacity: int, items: Sequence[int] = ()):
        self.capacity = int(capacity)
        self.items: List[int] = list(items)

    @property
    def size(self) -> int:
        return len(self.items)

    def push(self, ids: Sequence[int]) -> int:
        n = max(min(len(ids), self.capacity - len(self.items)), 0)
        self.items.extend(ids[:n])
        return n

    def pop(self) -> Optional[int]:
        return self.items.pop() if self.items else None

    def pop_bulk(self, max_n: int, n: int) -> List[int]:
        k = max(min(n, len(self.items), max_n), 0)
        block = self.items[len(self.items) - k:]
        del self.items[len(self.items) - k:]
        return block  # oldest of the popped block first, like the op

    def steal_front(self, k: int) -> List[int]:
        k = max(min(k, len(self.items)), 0)
        block = self.items[:k]
        del self.items[:k]
        return block

    def steal_exact(self, n: int, max_steal: int) -> List[int]:
        return self.steal_front(int(np.clip(n, 0, min(len(self.items),
                                                      max_steal))))

    def steal(self, proportion: float, queue_limit: int,
              max_steal: int) -> List[int]:
        return self.steal_front(_mirror_steal_plan(
            len(self.items), proportion, queue_limit, max_steal))


# ---------------------------------------------------------------------------
# Device-side helpers
# ---------------------------------------------------------------------------


def _seed_state(capacity: int, ids: Sequence[int], lo: int,
                device) -> QueueState:
    """A queue with its live block at an arbitrary cursor (wrapped
    cursors are histories of their own)."""
    buf = np.zeros((capacity,), np.int32)
    for i, x in enumerate(ids):
        buf[(lo + i) % capacity] = x
    return QueueState(
        buf=torch.from_numpy(buf).to(device),
        lo=torch.tensor(lo % capacity, dtype=torch.int32, device=device),
        size=torch.tensor(len(ids), dtype=torch.int32, device=device))


def _live_ids(q: QueueState) -> List[int]:
    buf = q.buf.cpu().numpy()
    lo, size = int(q.lo), int(q.size)
    return [int(buf[(lo + i) % buf.shape[0]]) for i in range(size)]


def _batch_ids(batch: torch.Tensor, n: int) -> List[int]:
    return [int(x) for x in batch.cpu().numpy()[:n]]


def _dead_rows_zero(batch: torch.Tensor, n: int) -> bool:
    return not np.any(batch.cpu().numpy()[n:])


# ---------------------------------------------------------------------------
# Scripts and interleavings
# ---------------------------------------------------------------------------

# Owner ops: ("push", k) - k fresh ids; ("pop",); ("pop_bulk", max_n, n).
# Stealer ops: ("steal", p); ("steal_exact", n).


def owner_scripts(cap: int) -> List[List[tuple]]:
    return [
        [],
        [("push", 2)],
        [("pop",)],
        [("pop",), ("pop",)],
        [("push", cap)],                        # overfill: clamps to space
        [("pop",), ("push", 2)],                # dip-and-refill
        [("pop_bulk", 2, 2), ("push", 3)],      # deeper dip, slot reuse
        [("push", 1), ("pop",)],
    ]


def stealer_scripts(max_steal: int) -> List[List[tuple]]:
    return [
        [("steal_exact", 1)],
        [("steal_exact", max_steal)],
        [("steal", 0.5)],
        [("steal", 1.0)],
        [("steal_exact", 1), ("steal_exact", max_steal)],
    ]


def initial_states(cap: int) -> List[Tuple[int, int]]:
    """(seed_size, lo) pairs: empty, small, nearly full; straight and
    wrapped cursors."""
    return [(0, 0), (2, cap - 2), (cap - 1, 1)]


def expand_stealer(script: Sequence[tuple], split: bool
                   ) -> List[Tuple[str, tuple]]:
    """The stealer's atomic steps: one per steal when fenced; the read
    and the reconcile when split, expanded BEFORE interleaving so owner
    ops can land between them."""
    steps: List[Tuple[str, tuple]] = []
    for op in script:
        if split:
            steps.append(("read", op))
            steps.append(("reconcile", op))
        else:
            steps.append(("stealer", op))
    return steps


def interleavings(owner: Sequence[tuple],
                  stealer_steps: Sequence[Tuple[str, tuple]]):
    """Every merge of the two threads that keeps each thread's order."""
    total = len(owner) + len(stealer_steps)
    for owner_slots in itertools.combinations(range(total), len(owner)):
        slots = set(owner_slots)
        o = iter(owner)
        s = iter(stealer_steps)
        yield [("owner", next(o)) if i in slots else next(s)
               for i in range(total)]


# ---------------------------------------------------------------------------
# History execution
# ---------------------------------------------------------------------------


ReconcileFn = Callable[..., Tuple[QueueState, torch.Tensor, torch.Tensor]]


def _default_reconcile(q, window, claim, max_steal, floor):
    return relaxed_mod.reconcile(q, window, claim, max_steal, floor=floor)


def _mut_no_floor(q, window, claim, max_steal, floor):
    """Seeded bug: settle against the current size only, ignoring the
    stable-prefix floor: pop-then-push owner schedules hand out stale
    rows and lose the refilled items."""
    return relaxed_mod.reconcile(q, window, claim, max_steal, floor=None)


def _mut_no_size_clamp(q, window, claim, max_steal, floor):
    """Seeded bug: settle the raw claim clamped only to the window — size
    can go negative and over-claimed rows escape."""
    cap = q.buf.shape[0]
    n = torch.clamp(torch.as_tensor(claim, dtype=torch.int32,
                                    device=q.size.device), 0, max_steal)
    offs = torch.arange(max_steal, dtype=torch.int32, device=q.size.device)
    batch = torch.where(offs < n, window, torch.zeros_like(window))
    return (QueueState(buf=q.buf, lo=(q.lo + n) % cap, size=q.size - n),
            batch, n)


MUTATIONS: Dict[str, ReconcileFn] = {
    "no-floor": _mut_no_floor,
    "no-size-clamp": _mut_no_size_clamp,
}


class _HistoryRun:
    """Execute one interleaving against one backend, mirroring the
    sequential spec, and collect violations (empty = linearizable)."""

    def __init__(self, ops: bulk_ops.BulkOps, ref: bulk_ops.BulkOps,
                 capacity: int, max_steal: int, seed: Tuple[int, int],
                 device, *, split_steals: bool,
                 reconcile_fn: ReconcileFn = _default_reconcile):
        self.ops, self.ref, self.device = ops, ref, device
        self.cap, self.ms = capacity, max_steal
        self.split = split_steals
        self.reconcile_fn = reconcile_fn
        n_seed, lo = seed
        seed_ids = list(range(1, n_seed + 1))
        self.next_id = n_seed + 1
        self.q = _seed_state(capacity, seed_ids, lo, device)
        self.spec = SeqSpec(capacity, seed_ids)
        self.exp_lo = lo % capacity
        self.pushed: List[int] = list(seed_ids)
        self.escaped: List[int] = []
        self.pending: Optional[dict] = None  # outstanding optimistic read
        self.violations: List[str] = []
        self.bound = (ops.multiplicity_bound(max_steal)
                      if hasattr(ops, "multiplicity_bound") else 0)

    def bad(self, msg: str) -> None:
        self.violations.append(msg)

    def _i32(self, x: int) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.int32, device=self.device)

    # -- shared postconditions ----------------------------------------------

    def _state_invariants(self, tag: str) -> None:
        size, lo = int(self.q.size), int(self.q.lo)
        if size < 0:
            self.bad(f"{tag}: size went NEGATIVE ({size})")
        if size > self.cap:
            self.bad(f"{tag}: size {size} exceeds capacity {self.cap}")
        if lo != self.exp_lo:
            self.bad(f"{tag}: cursor lo={lo}, expected {self.exp_lo} "
                     f"(linearization is the single cursor bump)")

    def _match_spec(self, tag: str) -> None:
        live = _live_ids(self.q)
        if live != self.spec.items:
            self.bad(f"{tag}: live queue {live} != spec {self.spec.items}")

    # -- owner steps ---------------------------------------------------------

    def owner_step(self, op: tuple) -> None:
        kind = op[0]
        if kind == "push":
            k = op[1]
            ids = list(range(self.next_id, self.next_id + k))
            self.next_id += k
            self.pushed.extend(ids)
            batch = torch.tensor(ids, dtype=torch.int32, device=self.device)
            self.q, n = self.ops.push(self.q, batch, self._i32(k))
            exp = self.spec.push(ids)
            if int(n) != exp:
                self.bad(f"push: n_pushed={int(n)}, spec says {exp}")
            for lost in ids[exp:]:  # rejected by the clamp: never entered
                self.pushed.remove(lost)
        elif kind == "pop":
            self.q, item, valid = self.ops.pop(self.q)
            exp = self.spec.pop()
            if bool(valid) != (exp is not None):
                self.bad(f"pop: valid={bool(valid)}, spec "
                         f"{'has' if exp is not None else 'lacks'} an item")
            elif exp is not None:
                if int(item) != exp:
                    self.bad(f"pop: item {int(item)} != spec {exp}")
                self.escaped.append(int(item))
        elif kind == "pop_bulk":
            _, max_n, n_req = op
            self.q, batch, n = self.ops.pop_bulk(self.q, max_n,
                                                 self._i32(n_req))
            exp = self.spec.pop_bulk(max_n, n_req)
            got = _batch_ids(batch, int(n))
            if int(n) != len(exp) or got != exp:
                self.bad(f"pop_bulk: got {got} (n={int(n)}), spec {exp}")
            if not _dead_rows_zero(batch, int(n)):
                self.bad("pop_bulk: dead rows not zeroed")
            self.escaped.extend(got)
        else:
            raise ValueError(f"unknown owner op {op}")
        self._state_invariants(f"owner {kind}")
        self._match_spec(f"owner {kind}")
        if self.pending is not None:
            self.pending["floor"] = min(self.pending["floor"],
                                        int(self.q.size))

    # -- stealer steps (fenced / atomic) -------------------------------------

    def fenced_steal(self, op: tuple) -> None:
        kind = op[0]
        if kind == "steal_exact":
            self.q, batch, n = self.ops.steal_exact(
                self.q, self._i32(op[1]), max_steal=self.ms)
            exp = self.spec.steal_exact(op[1], self.ms)
        else:
            self.q, batch, n = self.ops.steal(
                self.q, op[1], max_steal=self.ms, queue_limit=QUEUE_LIMIT)
            exp = self.spec.steal(op[1], QUEUE_LIMIT, self.ms)
        got = _batch_ids(batch, int(n))
        if int(n) != len(exp) or got != exp:
            self.bad(f"{kind}: stole {got} (n={int(n)}), spec {exp}")
        if not _dead_rows_zero(batch, int(n)):
            self.bad(f"{kind}: dead rows not zeroed")
        self.escaped.extend(got)
        self.exp_lo = (self.exp_lo + int(n)) % self.cap
        self._state_invariants(f"stealer {kind}")
        self._match_spec(f"stealer {kind}")

    # -- stealer steps (relaxed / split) -------------------------------------

    def relaxed_read(self, op: tuple) -> None:
        size = int(self.q.size)
        window = relaxed_mod.optimistic_read(self.q, self.ms)
        if op[0] == "steal_exact":
            claim = int(op[1])
        else:
            # Listing 4's claim, unclamped (the read consults no bound).
            mult = np.float32(1.0 - float(op[1]))
            keep = int(np.floor(np.float32(size) * mult))
            claim = 0 if size < QUEUE_LIMIT else size - keep
        over = min(max(claim, 0), self.ms)
        if over - min(over, size) > self.bound:
            self.bad(f"{op[0]} read: transient over-claim {over} beyond "
                     f"size {size} exceeds multiplicity bound {self.bound}")
        self.pending = {"window": window.clone(), "claim": claim,
                        "floor": size, "op": op[0]}

    def relaxed_reconcile(self) -> None:
        pend = self.pending
        self.pending = None
        size_now = int(self.q.size)
        q2, batch, n = self.reconcile_fn(
            self.q, pend["window"], self._i32(pend["claim"]), self.ms,
            self._i32(pend["floor"]))
        n = int(n)
        tag = f"{pend['op']} reconcile"
        n_exp = min(int(np.clip(pend["claim"], 0, self.ms)),
                    max(pend["floor"], 0), size_now)
        if n != n_exp:
            self.bad(f"{tag}: settled n={n}, the stable-prefix contract "
                     f"says min(claim clamp, floor={pend['floor']}, "
                     f"size={size_now}) = {n_exp}")
        # The settle must be exactly a fenced steal of n CURRENT items.
        r_q, r_batch, r_n = self.ref.steal_exact(self.q, self._i32(n),
                                                 max_steal=self.ms)
        exp = self.spec.steal_front(min(max(n, 0), size_now))
        self.q = q2
        got = _batch_ids(batch, max(n, 0))
        ref_got = _batch_ids(r_batch, int(r_n))
        if n != int(r_n) or got != ref_got or got != exp:
            self.bad(f"{tag}: settled {got} (n={n}), fenced oracle says "
                     f"{ref_got} (n={int(r_n)}), spec {exp}")
        if n >= 0 and not _dead_rows_zero(batch, n):
            self.bad(f"{tag}: withdrawn rows not zeroed")
        claim_bounded = min(max(pend["claim"], 0), self.ms)
        if claim_bounded - max(n, 0) > self.bound:
            self.bad(f"{tag}: over-claim {claim_bounded - max(n, 0)} "
                     f"exceeds multiplicity bound {self.bound}")
        self.escaped.extend(got)
        self.exp_lo = (self.exp_lo + n) % self.cap
        self._state_invariants(tag)
        if int(self.q.size) >= 0:
            self._match_spec(tag)

    # -- drive ---------------------------------------------------------------

    def run(self, steps: Sequence[Tuple[str, tuple]]) -> List[str]:
        for role, op in steps:
            if role == "owner":
                self.owner_step(op)
            elif role == "stealer":
                self.fenced_steal(op)
            elif role == "read":
                self.relaxed_read(op)
            else:
                self.relaxed_reconcile()
            if self.violations:
                break  # the first divergence is the story
        if not self.violations:
            self._conservation()
        return self.violations

    def _conservation(self) -> None:
        counts = Counter(self.escaped) + Counter(_live_ids(self.q))
        counts.pop(0, None)  # the dead-row filler is not an item
        for item in self.pushed:
            mult = counts.get(item, 0)
            if mult == 0:
                self.bad(f"conservation: item {item} LOST")
            elif mult > max(self.bound, 1):
                self.bad(f"conservation: item {item} multiplicity {mult} "
                         f"exceeds bound {max(self.bound, 1)}")
        ghost = set(counts) - set(self.pushed)
        if ghost:
            self.bad(f"conservation: ghost items {sorted(ghost)} appeared")


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def check_backend(backend: str, *, capacity: int, max_steal: int,
                  reconcile_fn: ReconcileFn = _default_reconcile,
                  max_violations: int = 10,
                  device=None) -> Tuple[int, List[str]]:
    """Check every scripted history of one backend on one geometry, on
    ``device`` (``None`` means CUDA).  Returns ``(n_histories,
    violations)``; stops after ``max_violations`` failing histories."""
    dev = resolve_device(device)
    ops = bulk_ops.make_ops(backend, capacity=capacity, max_steal=max_steal)
    ref = bulk_ops.make_ops("reference")
    # Split steps need the optimistic routing (the fallback is fenced).
    split = backend == "relaxed" and ops.resolved == "relaxed"
    n_hist = 0
    violations: List[str] = []
    for seed in initial_states(capacity):
        for o_script in owner_scripts(capacity):
            for s_script in stealer_scripts(max_steal):
                s_steps = expand_stealer(s_script, split)
                for steps in interleavings(o_script, s_steps):
                    n_hist += 1
                    run = _HistoryRun(ops, ref, capacity, max_steal, seed,
                                      dev, split_steals=split,
                                      reconcile_fn=reconcile_fn)
                    bad = run.run(steps)
                    if bad:
                        trace = " ; ".join(f"{r}:{o[0]}" for r, o in steps)
                        violations.append(
                            f"[{backend} cap={capacity} ms={max_steal} "
                            f"seed={seed}] {trace} -> {bad[0]}")
                        if len(violations) >= max_violations:
                            return n_hist, violations
    return n_hist, violations


def check_all(backends: Sequence[str] = ALL_BACKENDS, *,
              geometries: Sequence[Tuple[int, int]] = ((4, 2), (8, 4)),
              verbose: bool = False, device=None,
              counts: Optional[Dict[Tuple[str, int, int], int]] = None
              ) -> Tuple[int, List[str]]:
    """Every backend on every geometry.  Returns ``(total histories,
    violations)``; ``counts``, when given, receives the histories of each
    ``(backend, capacity, max_steal)``."""
    total = 0
    violations: List[str] = []
    for cap, ms in geometries:
        for backend in backends:
            n, bad = check_backend(backend, capacity=cap, max_steal=ms,
                                   device=device)
            total += n
            violations.extend(bad)
            if counts is not None:
                counts[(backend, cap, ms)] = n
            if verbose:
                status = "FAIL" if bad else "ok"
                print(f"  {backend:<10} cap={cap} max_steal={ms}: "
                      f"{n} histories {status}", flush=True)
    return total, violations


def run_mutations(*, capacity: int = 4, max_steal: int = 2,
                  verbose: bool = False, device=None) -> Dict[str, int]:
    """Run the relaxed histories under each seeded reconcile mutation;
    returns the violating histories caught per mutation (every entry must
    be > 0 for the checker to be trusted)."""
    caught: Dict[str, int] = {}
    for name, fn in MUTATIONS.items():
        _, bad = check_backend("relaxed", capacity=capacity,
                               max_steal=max_steal, reconcile_fn=fn,
                               device=device)
        caught[name] = len(bad)
        if verbose and bad:
            print(f"  mutation {name}: caught ({len(bad)} violating "
                  f"histories), e.g.\n    {bad[0]}", flush=True)
    return caught


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backends", default=",".join(ALL_BACKENDS),
                        help="comma-separated backend names")
    parser.add_argument("--quick", action="store_true",
                        help="the smallest geometry only")
    parser.add_argument("--mutate", action="store_true",
                        help="check that the seeded reconcile mutations "
                             "are caught (exit 1 if any slips through)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    if args.mutate:
        print("linearize --mutate: seeded relaxed-reconcile bugs must be "
              "caught ...", flush=True)
        caught = run_mutations(verbose=True, device=args.device)
        missed = [name for name, n in caught.items() if n == 0]
        if missed:
            print(f"CHECKER CANNOT FAIL: mutations {missed} produced no "
                  f"violations", flush=True)
            return 1
        print(f"ok: all {len(caught)} seeded mutations caught "
              f"({sum(caught.values())} violating histories)", flush=True)
        return 0

    backends = tuple(b for b in args.backends.split(",") if b)
    geometries = ((4, 2),) if args.quick else ((4, 2), (8, 4))
    total, violations = check_all(backends, geometries=geometries,
                                  verbose=True, device=args.device)
    if violations:
        print(f"\n{len(violations)} violating histor"
              f"{'y' if len(violations) == 1 else 'ies'} "
              f"(of {total}):", flush=True)
        for v in violations:
            print(f"  {v}", flush=True)
        return 1
    print(f"linearizable: {total} histories x {len(backends)} backend(s) "
          f"({', '.join(backends)}), no violations", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
