"""Each lane's peak ring size and the rows a full ring refused, counted
on the device after every push of the worker body.  The program keeps
neither (``ops.push`` clamps a push to the free rows and
``parallel._make_worker_body`` drops the count), so the benchmark counts
them from outside, in a run of their own (``bench/sweep.py``'s): the
count launches kernels inside every worker body, and the traced run,
whose times the per-layer metrics read, holds none of them."""

from __future__ import annotations

import contextlib

__all__ = ["counted"]


class _CountingOps:
    """The runtime's queue ops as the worker body sees them, with each
    push's outcome counted."""

    def __init__(self, ops, counter: "_Counter") -> None:
        self._ops = ops
        self._counter = counter

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def push(self, q, batch, n, **kw):
        q, pushed = self._ops.push(q, batch, n, **kw)
        self._counter.note(q.size, n, pushed)
        return q, pushed


class _Counter:
    def __init__(self, torch) -> None:
        self.torch = torch
        self.peak = None        # device: largest lane size after a push
        self.clamped = None     # device: rows a full ring refused

    def note(self, size, n, pushed) -> None:
        t = self.torch
        peak = size.amax().to(t.int64)
        clamped = (n - pushed).sum().to(t.int64)
        if self.peak is None:
            self.peak, self.clamped = peak, clamped
        else:
            self.peak = t.maximum(self.peak, peak)
            self.clamped = self.clamped + clamped

    def counts(self) -> dict:
        return {"ring_peak_rows": None if self.peak is None
                else int(self.peak),
                "ring_clamped_rows": None if self.clamped is None
                else int(self.clamped)}


@contextlib.contextmanager
def counted(parallel, torch):
    """Within the block, every worker body that ``parallel`` (the module
    ``repro_torch.core.dd.parallel``) makes counts its pushes; yields the
    counter, whose ``counts()`` reads them once the block's work is
    done."""
    counter = _Counter(torch)
    make_body = parallel._make_worker_body

    def _make_worker_body(weights, profits, ops, *a, **kw):
        return make_body(weights, profits, _CountingOps(ops, counter),
                         *a, **kw)

    parallel._make_worker_body = _make_worker_body
    try:
        yield counter
    finally:
        parallel._make_worker_body = make_body
