"""One CUDA graph per :meth:`~repro_torch.runtime.executor.StealRuntime.
run_fused` block, captured once per geometry in a process and replayed
for every later block of that geometry.

A block of k rounds issues a few hundred small operations a round from
Python, and nothing in it reads a device value on the host, so the whole
block can be captured as one graph.  Its addresses are fixed at capture,
so the graph reads and writes static tensors that an entry of this
module's cache owns: the rings, cursors and sizes of the queues, the
carry and the float32 proportion.  The block ends by copying its outputs
back into those inputs, so a replay runs in place; the per-round stats
and the block's one read-back vector are the graph's own outputs.

Opt-in.  A worker body that can be replayed carries ``_graph_key``, a
hashable value naming all that fixes its work besides its queues and its
carry, the only tensors it may read
(:func:`repro_torch.core.dd.parallel.parallel_solve` sets it, and keeps
the instance's items in the carry).  The
runtime adds its own geometry to it (:meth:`StealRuntime._graph_key`:
device, lanes, capacity, item spec, policy, adaptive config, backend,
carry layout, k, ``until_drained``) and replays only on stacked lanes on
a CUDA device, with no fault layer, no sanitizer and no armed phase
probe; every other block runs the eager path.

The cache holds at most :data:`MAX_ENTRIES` geometries; a geometry past
that runs eager.  The first block of a geometry in a process runs eager,
which warms the allocator and cub's sort workspace; the next one
captures.  An entry is held by one block at a time, or by one
:meth:`~repro_torch.runtime.executor.StealRuntime.run` from its first
replay to its end, and the results are copied off its static tensors
before it is let go: a block whose entry another holds runs eager, and
runtimes of one geometry take turns at an entry.  One capture runs at a
time in the process, in the ``thread_local`` capture mode, so that
other threads may go on issuing eager work meanwhile.  No capture is
made while a profiler runs; replays are.

A capture runs the block's Python without running its kernels, so the
kernel wrappers' launch counters (``<wrapper>.launches``) note its
launches instead of counting them, and every replay counts them
(:func:`repro_torch.kernels._lib.recording`): the counters still mean
launches on the card.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Hashable, Optional

import torch

from repro_torch.kernels import _lib

__all__ = ["MAX_ENTRIES", "BlockGraph", "acquire", "supported", "capture"]

# geometries a process keeps captured blocks of
MAX_ENTRIES = 4

_entries: Dict[Hashable, "BlockGraph"] = {}
_warm: set = set()  # keys that have run one eager block in this process
_lock = threading.Lock()
_capturing = threading.Lock()  # one capture at a time in the process


def supported(device: torch.device) -> bool:
    """Whether blocks on ``device`` can be captured."""
    return device.type == "cuda"


def capture(fn: Callable, device: torch.device) -> Callable:
    """Capture ``fn()`` as a CUDA graph on ``device``; returns the replay:
    a function that runs the graph and returns what ``fn`` returned at
    capture (the graph's static outputs)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        out = fn()

    def replay():
        graph.replay()
        return out

    return replay


class BlockGraph:
    """One captured block: its static inputs (``queues``, ``carry``,
    ``p``), its replay, and the launches its capture noted.  Held by one
    block at a time (:func:`acquire`)."""

    def __init__(self, key: Hashable) -> None:
        self.key = key
        self.queues = self.carry = self.p = None
        self.replay_fn: Optional[Callable] = None
        self.noted: Dict = {}
        self._busy = threading.Lock()

    @property
    def captured(self) -> bool:
        return self.replay_fn is not None

    def capture(self, fn: Callable, device: torch.device) -> None:
        """Capture ``fn``, noting the launches it issues; a capture that
        fails takes the entry out of the cache."""
        try:
            with _capturing, _lib.recording() as noted:
                self.replay_fn = capture(fn, device)
        except BaseException:
            with _lock:
                _entries.pop(self.key, None)
            raise
        self.noted = dict(noted)

    def replay(self):
        """Run the block and count its launches; returns its outputs."""
        out = self.replay_fn()
        _lib.replayed(self.noted)
        return out

    def release(self) -> None:
        self._busy.release()


def acquire(key: Optional[Hashable]) -> Optional[BlockGraph]:
    """The entry of ``key``, held for one block; None when the block runs
    eager: no key, the geometry's first block in this process, a full
    cache, an entry in use, or a capture that would run under a
    profiler."""
    if key is None:
        return None
    with _lock:
        if key not in _warm:
            _warm.add(key)
            return None
        entry = _entries.get(key)
        if entry is None:
            if len(_entries) >= MAX_ENTRIES:
                return None
            entry = _entries[key] = BlockGraph(key)
    if not entry.captured and torch.autograd._profiler_enabled():
        return None
    if not entry._busy.acquire(blocking=False):
        return None
    return entry
