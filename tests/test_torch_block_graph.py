"""The replayed ``run_fused`` block (``repro_torch.runtime.block_graph``)
on the CPU.  A stand-in takes the place of the CUDA graph: its capture
records the block's closure, without running it, and each replay re-runs
that closure on the entry's static tensors.  Replayed solves must be
bit-equal to eager ones, one capture must serve a whole series of one
geometry, the launch counters must advance by a block's launches at
every replay, and every block the graph path does not take must run the
eager path."""

import sys
import threading

import pytest
import torch

from repro_torch.core import ops as bulk_ops
from repro_torch.core.dd.knapsack import dp_solve, random_instance
from repro_torch.core.dd.parallel import parallel_solve
from repro_torch.core.policy import StealPolicy
from repro_torch.kernels import _lib
from repro_torch.kernels.dd_expand.ops import explore_fused
from repro_torch.kernels.queue_push.ops import pop_slice, push_scatter
from repro_torch.kernels.queue_steal.ops import steal_gather
from repro_torch.kernels.queue_transfer.ops import transfer_splice
from repro_torch.runtime import FaultPlan, StealRuntime, block_graph

from _torch_parity import one_torch_thread  # noqa: F401

I32 = torch.int32
SOLVER = dict(n_workers=4, explore_width=8, batch=4, capacity=512,
              fused_rounds=4)
# what a capture's Python issues of one kernel wrapper, in the stand-in
CAPTURED_LAUNCHES = 3
COUNTERS = (explore_fused, push_scatter, pop_slice, steal_gather,
            transfer_splice)
SOLVE_KEYS = ("supersteps", "explored", "transferred", "per_worker_explored",
              "ring_refused_rows", "ring_peak_rows", "per_worker_ring_peak",
              "telemetry")


@pytest.fixture
def stand_in(monkeypatch):
    """Blocks on the CPU replayable, the CUDA graph replaced by the
    stand-in; returns the closures captured."""
    captured = []

    def capture(fn, device):
        captured.append(fn)
        # a real capture runs the block's Python, its launches included
        for _ in range(CAPTURED_LAUNCHES):
            _lib.counted(explore_fused)
        return fn

    for counter in COUNTERS:
        monkeypatch.setattr(counter, "launches", 0)
    monkeypatch.setattr(block_graph, "supported", lambda device: True)
    monkeypatch.setattr(block_graph, "capture", capture)
    monkeypatch.setattr(block_graph, "_entries", {})
    monkeypatch.setattr(block_graph, "_warm", set())
    return captured


def _series(n=16, seeds=range(8)):
    """Instances of one geometry, each solved in two blocks or more."""
    return [random_instance(n, seed=s) for s in seeds]


def _solve_all(insts):
    return [parallel_solve(inst, device="cpu", **SOLVER) for inst in insts]


def _assert_same_solves(got, want):
    for (g_opt, g), (w_opt, w) in zip(got, want):
        assert g_opt == w_opt
        for key in SOLVE_KEYS:
            assert g[key] == w[key], key


def test_a_series_replays_bit_equal_to_eager(stand_in):
    insts = _series()
    block_graph.supported, saved = (lambda device: False,
                                    block_graph.supported)
    try:
        eager = _solve_all(insts)
    finally:
        block_graph.supported = saved
    assert all(st["graph_replays"] == 0 for _, st in eager)
    replayed = _solve_all(insts)
    _assert_same_solves(replayed, eager)
    assert [opt for opt, _ in replayed] == [dp_solve(i) for i in insts]
    # one capture, on the first solve's second block; every later block
    # of the series replays
    assert [st["graph_captures"] for _, st in replayed] == [1] + [0] * 7
    assert len(stand_in) == 1
    assert replayed[0][1]["graph_eager_blocks"] == 1
    for (_, st), (_, ref) in zip(replayed, eager):
        assert (st["graph_replays"] + st["graph_eager_blocks"]
                == ref["graph_eager_blocks"])
    assert all(st["graph_eager_blocks"] == 0 for _, st in replayed[1:])


def test_launch_counters_advance_per_replay(stand_in):
    out = _solve_all(_series(seeds=range(3)))
    replays = sum(st["graph_replays"] for _, st in out)
    assert replays > 0
    assert explore_fused.launches == CAPTURED_LAUNCHES * replays
    assert all(c.launches == 0 for c in COUNTERS[1:])


def test_a_capture_notes_only_its_own_threads_launches():
    """Launches are noted, not counted, on the thread that captures, and
    counted at once on any other; each replay counts what was noted."""
    other = threading.Thread(target=_lib.counted, args=(steal_gather,))
    before = (explore_fused.launches, steal_gather.launches)
    with _lib.recording() as noted:
        _lib.counted(explore_fused)
        _lib.counted(explore_fused)
        other.start()
        other.join()
    assert (explore_fused.launches, steal_gather.launches) == (
        before[0], before[1] + 1)
    assert dict(noted) == {explore_fused: 2}
    _lib.replayed(noted)
    _lib.replayed(noted)
    assert explore_fused.launches == before[0] + 4
    _lib.counted(explore_fused)
    assert explore_fused.launches == before[0] + 5


def test_a_second_geometry_is_captured_apart(stand_in):
    small, large = _series(seeds=range(2)), _series(n=14, seeds=(1, 2))
    out = _solve_all(small + large + small)
    assert [st["graph_captures"] for _, st in out] == [1, 0, 1, 0, 0, 0]
    assert [opt for opt, _ in out] == [dp_solve(i)
                                       for i in small + large + small]


def test_the_items_ride_in_the_carry(stand_in):
    """Instances of one geometry share its entry: the body reads each
    solve's items from the carry, which every block copies in."""
    a, b = random_instance(16, seed=3), random_instance(16, seed=4)
    out = _solve_all([a, b, a])
    assert [opt for opt, _ in out] == [dp_solve(i) for i in (a, b, a)]
    assert [st["graph_captures"] for _, st in out] == [1, 0, 0]
    assert all(st["graph_replays"] > 0 for _, st in out)
    assert len(block_graph._entries) == 1


def test_a_geometry_past_the_cache_runs_eager(stand_in, monkeypatch):
    monkeypatch.setattr(block_graph, "MAX_ENTRIES", 1)
    first, second = _series(seeds=range(2)), _series(n=14, seeds=(1, 2))
    out = _solve_all(first + second)
    assert [st["graph_captures"] for _, st in out] == [1, 0, 0, 0]
    assert all(st["graph_replays"] == 0 for _, st in out[2:])
    assert [opt for opt, _ in out] == [dp_solve(i) for i in first + second]


# ------------------------------------------------ the runtime's own rules

W, CAP, POP, FANOUT, NODES = 4, 256, 4, 3, 400


def _dag_body(ops, key=("dag",)):
    """Pop up to ``POP`` nodes a lane, push their children below
    ``NODES``; the carry counts the nodes each lane explored."""

    def body(q, carry):
        q, nodes, n = ops.pop_bulk(q, POP, POP, donate=True)
        valid = torch.arange(POP, dtype=I32)[None, :] < n[:, None]
        kids = nodes[:, :, None] * FANOUT + 1 + torch.arange(FANOUT,
                                                             dtype=I32)
        live = (valid[:, :, None] & (kids < NODES)).reshape(W, -1)
        order = torch.argsort((~live).to(I32), dim=1, stable=True)
        flat = kids.reshape(W, -1).gather(1, order)
        q, _ = ops.push(q, flat, live.sum(1).to(I32), donate=True)
        return q, carry + valid.sum(1).to(I32)

    if key is not None:
        body._graph_key = key
    return body


def _runtime(**kw):
    rt = StealRuntime(W, CAP, torch.zeros((), dtype=I32), device="cpu",
                      policy=StealPolicy(proportion=0.5, low_watermark=0,
                                         high_watermark=4, max_steal=64),
                      **kw)
    rt.push(0, torch.zeros((1,), dtype=I32), 1)
    return rt


def _drive(rt, body, blocks=4, k=3):
    """``blocks`` blocks of ``k`` rounds; every round's sizes and the
    carry."""
    carry, sizes = torch.zeros((W,), dtype=I32), []
    for _ in range(blocks):
        carry, stats = rt.run_fused(k, body, carry)
        sizes.append(stats.sizes_after.clone())
    return torch.cat(sizes).tolist(), carry.tolist(), rt.telemetry.summary()


def _eager_reference(**kw):
    rt = _runtime(**kw)
    return _drive(rt, _dag_body(rt.ops, key=None))


def test_the_runtime_replays_exactly_k_rounds(stand_in):
    rt = _runtime()
    got = _drive(rt, _dag_body(rt.ops))
    assert got == _eager_reference()
    assert rt.graph_blocks == {"captures": 1, "replays": 3, "eager": 1}


@pytest.mark.parametrize("case", ["probe", "check", "fault", "no_key",
                                  "rebalance", "in_use", "cache_full"])
def test_blocks_off_the_graph_path_run_eager(stand_in, monkeypatch, case):
    kw = {}
    if case == "check":
        kw["backend"] = bulk_ops.make_ops("reference", check=True)
    if case == "fault":
        kw["fault_plan"] = FaultPlan()
    rt = _runtime(**kw)
    if case == "probe":
        rt.attach_phase_probe()
    body = (None if case == "rebalance"
            else _dag_body(rt.ops, key=None if case == "no_key" else ("dag",)))
    carry = torch.zeros((W,), dtype=I32)
    key = rt._graph_key(body, carry, 3, False)
    if case == "in_use":
        held = block_graph.acquire(key)  # the geometry's first block: warm
        assert held is None
        held = block_graph.acquire(key)
        assert held is not None
    if case == "cache_full":
        monkeypatch.setattr(block_graph, "MAX_ENTRIES", 1)
        block_graph.acquire(("another",))
        block_graph.acquire(("another",)).release()
    if case in ("probe", "check", "fault", "no_key", "rebalance"):
        assert key is None
    got = _drive(rt, body) if body is not None else [
        rt.run_fused(3)[1].sizes_after.tolist() for _ in range(4)]
    assert rt.graph_blocks == {"captures": 0, "replays": 0, "eager": 4}
    assert stand_in == []
    if case in ("probe", "no_key", "in_use", "cache_full"):
        assert got == _eager_reference()
    if case == "in_use":
        held.release()
        _drive(rt, body, blocks=1)
        assert rt.graph_blocks["captures"] == 1


def test_the_first_block_of_a_geometry_warms_it(stand_in):
    """Until a geometry has run one eager block in the process nothing is
    captured; a later runtime of it captures on its first block."""
    rt = _runtime()
    _drive(rt, _dag_body(rt.ops), blocks=1)
    assert rt.graph_blocks == {"captures": 0, "replays": 0, "eager": 1}
    rt = _runtime()
    got = _drive(rt, _dag_body(rt.ops))
    assert rt.graph_blocks == {"captures": 1, "replays": 4, "eager": 0}
    assert got == _eager_reference()


def test_a_replay_leaves_the_runtime_on_its_own_tensors(stand_in):
    """A replay's queues, carry and stats are copies of the entry's
    static tensors, which the entry's next holder overwrites."""
    rt = _runtime()
    body = _dag_body(rt.ops)
    carry = torch.zeros((W,), dtype=I32)
    for _ in range(2):
        carry, stats = rt.run_fused(3, body, carry)
    [entry] = block_graph._entries.values()
    assert rt.graph_blocks["replays"] == 1
    assert torch.equal(carry, entry.carry) and carry is not entry.carry
    for mine, static in zip(rt.queues, entry.queues):
        assert torch.equal(mine, static) and mine is not static
    kept = (carry.clone(), stats.sizes_after.clone())
    entry.carry.zero_()
    entry.queues.size.zero_()
    assert torch.equal(carry, kept[0])
    assert torch.equal(stats.sizes_after, kept[1])
    assert int(rt.queues.size.sum()) > 0


def test_runtimes_of_one_geometry_take_turns_at_its_entry(stand_in):
    """Two runtimes of one geometry whose blocks alternate on its entry
    each end as the eager path does."""
    rts = [_runtime(), _runtime()]
    bodies = [_dag_body(rt.ops) for rt in rts]
    carries = [torch.zeros((W,), dtype=I32) for _ in rts]
    sizes = [[], []]
    for _ in range(4):
        for i, rt in enumerate(rts):
            carries[i], stats = rt.run_fused(3, bodies[i], carries[i])
            sizes[i].append(stats.sizes_after.clone())
    assert len(stand_in) == 1
    assert sum(rt.graph_blocks["replays"] for rt in rts) == 7
    for i, rt in enumerate(rts):
        got = (torch.cat(sizes[i]).tolist(), carries[i].tolist(),
               rt.telemetry.summary())
        assert got == _eager_reference()


def test_a_run_holds_its_graph_to_its_end(stand_in, monkeypatch):
    """``run`` acquires a geometry's graph once and keeps it: later
    blocks copy nothing in or out, and the end copies the results off
    the graph and lets it go."""
    acquired = []
    acquire = block_graph.acquire

    def counted_acquire(key):
        acquired.append(key)
        return acquire(key)

    monkeypatch.setattr(block_graph, "acquire", counted_acquire)
    want = _eager_reference_run()
    acquired.clear()
    rt = _runtime()
    carry = rt.run(_dag_body(rt.ops), torch.zeros((W,), dtype=I32),
                   fused=3)
    assert (carry.tolist(), rt.telemetry.summary()) == want
    assert rt.graph_blocks["captures"] == 1
    assert rt.graph_blocks["replays"] >= 3
    # the warm block, then the capture's: every later block held
    assert len(acquired) == 2
    [entry] = block_graph._entries.values()
    assert carry is not entry.carry and rt.queues is not entry.queues
    assert entry._busy.acquire(blocking=False)
    entry.release()


def _eager_reference_run():
    rt = _runtime()
    carry = rt.run(_dag_body(rt.ops, key=None),
                   torch.zeros((W,), dtype=I32), fused=3)
    return carry.tolist(), rt.telemetry.summary()


def test_entries_are_held_one_block_at_a_time(stand_in):
    """Threads contending for one geometry's entry: never two holders at
    once, and one entry in the cache."""
    key = ("contended",)
    assert block_graph.acquire(key) is None  # the geometry's first block
    held, most, count_lock = [0], [0], threading.Lock()

    def worker():
        for _ in range(300):
            entry = block_graph.acquire(key)
            if entry is None:
                continue
            with count_lock:
                held[0] += 1
                most[0] = max(most[0], held[0])
            with count_lock:
                held[0] -= 1
            entry.release()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1 and held[0] == 0
    assert list(block_graph._entries) == [key]
