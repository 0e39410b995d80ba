#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port only (``src/repro_torch``; it imports neither JAX nor
the JAX package) and fails — non-zero exit, no result line — on the first
check that does not hold:

1. Build and kernel parity.  Builds the four CUDA ring kernels from the
   checkout's sources (``repro_torch.kernels._lib``), holds each against
   its plain PyTorch version bit for bit — on the kernel case tables and at
   the solver's geometry (64 lanes, 16,384-row rings, max_steal 8,192,
   128-row pushes, 8-row pops) in float32, int32 and bfloat16 — and times
   kernel, plain version and the ``index_select`` / ``index_copy_``
   yardstick with CUDA events at the solver's shapes.
2. The queue at the paper's backlog.  64 lanes of 16,384 rows, half of
   them holding 10,000 seeded unique items; 8 rebalancing supersteps on the
   kernel backend under the compact and the dense exchange and on the
   reference backend.  Rings, cursors and round records must agree across
   the three runs, and every item must survive exactly once.
3. The DD solver at full size.  ``parallel_solve`` on a 30-item knapsack
   with 64 workers; it must reproduce the JAX package's integer results,
   and each of the four kernels must have launched during that run.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

# The solver's geometry (the repo's LFQConfig: 16,384-row rings, max_steal
# 8,192; 64 workers, a point of the Fig. 10 sweep; explore width 16 x batch
# 8 = 128-row child pushes, 8-row pops).
LANES, CAP, MAX_STEAL, PUSH_ROWS, POP_ROWS = 64, 16384, 8192, 128, 8

# What the JAX package's parallel_solve returns for PHASE3 (a CPU run of
# repro.core.dd.parallel.parallel_solve at commit ebd45d9, jax 0.9.0, all
# four ops on its kernel routing): optimum 1260 (= dp_solve), 44
# supersteps, 15,968 subproblems explored, 6,850 items transferred in 472
# steals.
PHASE3 = dict(n_items=30, seed=3, n_workers=LANES, explore_width=16,
              batch=8, capacity=CAP, max_steal=MAX_STEAL)
PHASE3_EXPECT = dict(optimum=1260, supersteps=44, explored=15968,
                     transferred=6850, steals=472)

KERNELS = (
    ("ring_gather", "src/repro_torch/kernels/queue_steal/ring_gather.cu",
     "src/repro/kernels/queue_steal/kernel.py:56"),
    ("ring_scatter", "src/repro_torch/kernels/queue_push/ring_push.cu",
     "src/repro/kernels/queue_push/kernel.py:85"),
    ("ring_slice", "src/repro_torch/kernels/queue_push/ring_push.cu",
     "src/repro/kernels/queue_push/kernel.py:155"),
    ("ring_transfer",
     "src/repro_torch/kernels/queue_transfer/ring_transfer.cu",
     "src/repro/kernels/queue_transfer/kernel.py:79"),
)


def _port():
    """The port's modules (imported late: the script must fail cleanly
    where there is no GPU or no checkout around it)."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels._lib as lib
    from repro_torch.kernels.queue_push import ops as push_ops
    from repro_torch.kernels.queue_steal import ops as steal_ops
    from repro_torch.kernels.queue_transfer import ops as transfer_ops
    return lib, {"ring_gather": steal_ops.steal_gather,
                 "ring_scatter": push_ops.push_scatter,
                 "ring_slice": push_ops.pop_slice,
                 "ring_transfer": transfer_ops.transfer_splice}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- timing


class Timer:
    """Per-call time of a function on ``device``.  On a GPU: CUDA events
    around ``n`` calls queued behind a device-side sleep, so the events
    see the device time of the calls and not the host's launch rate
    (``clean`` says whether the host finished queueing before the sleep
    ended).  On the CPU (tests) it is host time, and never reported."""

    def __init__(self, device):
        import torch
        self.torch, self.device = torch, device
        self.cycles_per_ms = None
        if device.type == "cuda":
            e0, e1 = self._events(2)
            torch.cuda.synchronize()
            e0.record()
            torch.cuda._sleep(10 ** 7)
            e1.record()
            torch.cuda.synchronize()
            self.cycles_per_ms = 10 ** 7 / e0.elapsed_time(e1)

    def _events(self, k):
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(k)]

    def ms(self, fn, n: int = 100):
        torch = self.torch
        for _ in range(3):
            fn()
        if self.device.type != "cuda":
            t = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t) * 1e3 / n, True
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        # A host slower than the sleep (a shared host, clocks that ramp
        # after the calibration) leaves the events timing its launch
        # rate: sleep longer and time again.
        for _ in range(4):
            e0, e1, e2 = self._events(3)
            e0.record()
            torch.cuda._sleep(int(self.cycles_per_ms * (2 * host_ms + 5)))
            e1.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host_ms = (time.perf_counter() - t) * 1e3
            e2.record()
            torch.cuda.synchronize()
            clean = host_ms < e0.elapsed_time(e1)
            if clean:
                break
        return e1.elapsed_time(e2) / n, clean


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------- phase 1: the kernels


def _bits(t):
    import torch
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[
        t.element_size()])


def _compare(kernel_out, plain_out, what: str) -> float:
    """Bit-exact check; returns the max abs difference (0.0)."""
    check(kernel_out.shape == plain_out.shape
          and kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype")
    same = bool((_bits(kernel_out) == _bits(plain_out)).all())
    err = float((kernel_out.double() - plain_out.double()).abs().max()) \
        if kernel_out.numel() else 0.0
    check(same, f"{what}: kernel differs from its plain version "
                f"(max abs err {err})")
    return err


def kernel_cases(device, rng):
    """Yield ``(kernel name, what, kernel_out, plain_out)`` over the case
    tables and the solver's geometry in float32, int32 and bfloat16."""
    import torch
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.queue_push.ops import ring_scatter, ring_slice
    from repro_torch.kernels.queue_push.ref import (ring_scatter_ref,
                                                    ring_slice_ref)
    from repro_torch.kernels.queue_steal.ops import ring_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    from repro_torch.kernels.queue_transfer.ops import ring_transfer
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

    def vec(x):
        return torch.tensor(np.asarray(x, np.int32).reshape(-1),
                            device=device)

    def ring(lanes, cap, d, dtype):
        return C.to_tensor(C.payload(rng, (lanes, cap, d), dtype), dtype,
                           device)

    def gather(lanes, cap, d, m, lo, n, dtype, what):
        buf = ring(lanes, cap, d, dtype)
        lo, n = vec(lo), vec(n)
        return ("ring_gather", what, ring_gather(buf, lo, n, m),
                ring_gather_ref(buf, lo, n, m))

    def scatter(lanes, cap, d, b, start, n, dtype, what):
        buf = ring(lanes, cap, d, dtype)
        batch = ring(lanes, b, d, dtype)
        start, n = vec(start), vec(n)
        return ("ring_scatter", what,
                ring_scatter(buf.clone(), batch, start, n),
                ring_scatter_ref(buf, batch, start,
                                 n.clamp(0, min(b, cap))))

    def slice_(lanes, cap, d, m, lo, size, n, dtype, what):
        buf = ring(lanes, cap, d, dtype)
        lo, size, n = vec(lo), vec(size), vec(n)
        return ("ring_slice", what, ring_slice(buf, lo, size, n, m),
                ring_slice_ref(buf, lo, size, n, m))

    def transfer(lanes, cap, d, w, m, head, src, n, dtype, what):
        buf = ring(lanes, cap, d, dtype)
        gathered = ring(w, m, d, dtype).reshape(w * m, d)
        head, src, n = vec(head), vec(src), vec(n)
        return ("ring_transfer", what,
                ring_transfer(buf.clone(), gathered, head, src, n, m),
                ring_transfer_ref(buf, gathered, head, src.long() * m,
                                  n.clamp(0, min(m, cap))))

    for cap, d, m, lo, n, dt in C.STEAL_CASES:
        yield gather(1, cap, d, m, lo, n, dt, f"table {cap},{d},{m},{dt}")
    for cap, d, b, start, n, dt in C.SCATTER_CASES:
        yield scatter(1, cap, d, b, start, n, dt, f"table {cap},{d},{b},{dt}")
    for cap, d, m, lo, size, n, dt in C.SLICE_CASES:
        yield slice_(1, cap, d, m, lo, size, n, dt,
                     f"table {cap},{d},{m},{dt}")
    for cap, d, w, m, head, src, n, dt in C.TRANSFER_CASES:
        yield transfer(1, cap, d, w, m, head, src, n, dt,
                       f"table {cap},{d},{w},{m},{dt}")
    for dt in ("float32", "int32", "bfloat16"):
        lo = rng.integers(0, CAP, LANES)
        size = rng.integers(0, CAP + 1, LANES)
        yield gather(LANES, CAP, 1, MAX_STEAL, lo,
                     rng.integers(0, MAX_STEAL + 1, LANES), dt, f"path {dt}")
        yield scatter(LANES, CAP, 1, PUSH_ROWS, lo,
                      rng.integers(0, PUSH_ROWS + 1, LANES), dt, f"path {dt}")
        yield slice_(LANES, CAP, 1, POP_ROWS, lo, size,
                     np.minimum(size, rng.integers(0, POP_ROWS + 1, LANES)),
                     dt, f"path {dt}")
        yield transfer(LANES, CAP, 1, LANES, MAX_STEAL, lo,
                       rng.permutation(LANES),
                       rng.integers(0, MAX_STEAL + 1, LANES), dt,
                       f"path {dt}")


def kernel_timings(device, rng, timer):
    """Per kernel at the solver's shapes (int32 rows, every lane moving its
    full count): kernel, plain version and library call times and the
    device-memory bound."""
    import torch
    from repro_torch.kernels.queue_push.ops import ring_scatter, ring_slice
    from repro_torch.kernels.queue_push.ref import (ring_scatter_ref,
                                                    ring_slice_ref)
    from repro_torch.kernels.queue_steal.ops import ring_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    from repro_torch.kernels.queue_transfer.ops import ring_transfer
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

    i32 = torch.int32
    buf = torch.tensor(rng.integers(0, 2 ** 30, (LANES, CAP, 1)), dtype=i32,
                       device=device)
    flat = buf.view(LANES * CAP, 1)
    base = torch.arange(LANES, device=device)[:, None] * CAP
    lo = torch.tensor(rng.integers(0, CAP, LANES), dtype=i32, device=device)
    size = torch.tensor(rng.integers(POP_ROWS, CAP + 1, LANES), dtype=i32,
                        device=device)

    def rows_of(start, m):
        return (base + (start.long()[:, None]
                        + torch.arange(m, device=device)) % CAP).reshape(-1)

    full_steal = torch.full((LANES,), MAX_STEAL, dtype=i32, device=device)
    full_push = torch.full((LANES,), PUSH_ROWS, dtype=i32, device=device)
    full_pop = torch.full((LANES,), POP_ROWS, dtype=i32, device=device)
    batch = torch.tensor(rng.integers(0, 2 ** 30, (LANES, PUSH_ROWS, 1)),
                         dtype=i32, device=device)
    gathered = torch.tensor(rng.integers(0, 2 ** 30, (LANES * MAX_STEAL, 1)),
                            dtype=i32, device=device)
    src = torch.tensor(rng.permutation(LANES), dtype=i32, device=device)
    win_idx = rows_of(lo, MAX_STEAL)
    pop_idx = rows_of(lo + size - POP_ROWS, POP_ROWS)
    push_idx = rows_of(lo, PUSH_ROWS)
    # src is a permutation, so window s lands in the one lane l with
    # src[l] == s: row s * MAX_STEAL + i of the stack goes to lane l's
    # physical row (lo[l] + i) % CAP.
    splice_idx = win_idx.view(LANES, MAX_STEAL)[
        torch.argsort(src.long())].reshape(-1)
    cursor = 4 * LANES

    specs = {
        # the compact exchange's window: every lane reads max_steal rows
        "ring_gather": (
            lambda: ring_gather(buf, lo, full_steal, MAX_STEAL),
            lambda: ring_gather_ref(buf, lo, full_steal, MAX_STEAL),
            lambda: flat.index_select(0, win_idx),
            2 * LANES * MAX_STEAL * 4 + 2 * cursor,
            "window at lo, n = max_steal on every lane"),
        "ring_scatter": (
            lambda: ring_scatter(buf, batch, lo, full_push),
            lambda: ring_scatter_ref(buf, batch, lo, full_push),
            lambda: flat.index_copy_(0, push_idx, batch.view(-1, 1)),
            2 * LANES * PUSH_ROWS * 4 + 2 * cursor,
            "128-row push on every lane"),
        "ring_slice": (
            lambda: ring_slice(buf, lo, size, full_pop, POP_ROWS),
            lambda: ring_slice_ref(buf, lo, size, full_pop, POP_ROWS),
            lambda: flat.index_select(0, pop_idx),
            2 * LANES * POP_ROWS * 4 + 3 * cursor,
            "8-row pop on every lane"),
        "ring_transfer": (
            lambda: ring_transfer(buf, gathered, lo, src, full_steal,
                                  MAX_STEAL),
            lambda: ring_transfer_ref(buf, gathered, lo,
                                      src.long() * MAX_STEAL, full_steal),
            lambda: flat.index_copy_(0, splice_idx, gathered),
            2 * LANES * MAX_STEAL * 4 + 3 * cursor,
            "max_steal rows from the window stack into every lane"),
    }
    # The library yardsticks compute the same function on these inputs.
    check(torch.equal(specs["ring_gather"][2]().view(LANES, MAX_STEAL, 1),
                      ring_gather(buf, lo, full_steal, MAX_STEAL)),
          "index_select yardstick != ring_gather")
    check(torch.equal(specs["ring_slice"][2]().view(LANES, POP_ROWS, 1),
                      ring_slice(buf, lo, size, full_pop, POP_ROWS)),
          "index_select yardstick != ring_slice")
    spliced = ring_transfer(buf.clone(), gathered, lo, src, full_steal,
                            MAX_STEAL)
    check(torch.equal(flat.clone().index_copy_(0, splice_idx, gathered),
                      spliced.view(LANES * CAP, 1)),
          "index_copy_ yardstick != ring_transfer")
    out = {}
    for name, (kern, plain, library, nbytes, what) in specs.items():
        ms, clean = timer.ms(kern)
        plain_ms, plain_clean = timer.ms(plain, n=20)
        lib_ms = timer.ms(library)[0]
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                         bound_bytes=nbytes, timed_at=what,
                         device_time_clean=clean and plain_clean)
    return out


def phase_kernels(device, seed: int = 0):
    rng = np.random.default_rng(seed)
    errs, counts = {}, {}
    for name, what, k_out, p_out in kernel_cases(device, rng):
        errs[name] = max(errs.get(name, 0.0),
                         _compare(k_out, p_out, f"{name} {what}"))
        counts[name] = counts.get(name, 0) + 1
    sync(device)
    timings = kernel_timings(device, rng, Timer(device))
    return {name: dict(max_abs_err=errs[name], parity_cases=counts[name],
                       **timings[name]) for name, _, _ in KERNELS}


# ------------------------------------------- phase 2: the paper's backlog


def phase_queue(device, *, lanes: int, capacity: int, backlog: int,
                max_steal: int, rounds: int, seed: int = 0):
    """``rounds`` supersteps from half the lanes holding ``backlog`` unique
    items, on the kernel backend (compact and dense exchange) and the
    reference backend; all three must agree and conserve every item."""
    import torch
    from repro_torch.configs.paper_lfq import CONFIG
    from repro_torch.core.ops import queue_to_numpy
    from repro_torch.core.policy import StealPolicy
    from repro_torch.runtime.executor import StealRuntime
    from repro_torch.runtime.telemetry import RoundRecord

    fields = [f.name for f in dataclasses.fields(RoundRecord)]
    rng = np.random.default_rng(seed)
    full = list(range(0, lanes, 2))
    ids = np.arange(len(full) * backlog, dtype=np.int32)
    items = {"layer": ids,
             "state": rng.integers(0, 2 ** 30, ids.size).astype(np.int32),
             "value": rng.integers(-2 ** 30, 2 ** 30, ids.size).astype(
                 np.int32)}
    spec = {k: torch.zeros((), dtype=torch.int32) for k in items}
    runs = {}
    # The first configuration runs twice; its first run only warms up.
    for backend, exchange in (("cuda", "compact"), ("cuda", "compact"),
                              ("cuda", "dense"), ("reference", "compact")):
        policy = StealPolicy(proportion=CONFIG.steal_proportion,
                             queue_limit=CONFIG.queue_limit,
                             low_watermark=CONFIG.low_watermark,
                             high_watermark=CONFIG.high_watermark,
                             max_steal=max_steal, exchange=exchange)
        rt = StealRuntime(lanes, capacity, spec, policy=policy,
                          backend=backend, device=device)
        for j, lane in enumerate(full):
            part = slice(j * backlog, (j + 1) * backlog)
            rt.push(lane, {k: v[part] for k, v in items.items()}, backlog)
        sync(device)
        t0 = time.perf_counter()
        rt.run_fused(rounds)
        sync(device)
        wall = time.perf_counter() - t0
        runs[f"{backend}/{exchange}"] = (
            queue_to_numpy(rt.queues),
            [dataclasses.astuple(r) for r in rt.telemetry.rounds], wall)

    q0, rec0, _ = runs["cuda/compact"]
    bytes_moved = fields.index("bytes_moved")
    for name, (q, rec, _) in runs.items():
        for k in items:
            check(np.array_equal(q.buf[k], q0.buf[k]), f"{name}: ring {k}")
        check(np.array_equal(q.lo, q0.lo) and np.array_equal(q.size, q0.size),
              f"{name}: cursors")
        # The exchanges differ only in the payload they account for.
        if name.endswith("dense"):
            rec = [r[:bytes_moved] + r[bytes_moved + 1:] for r in rec]
            ref = [r[:bytes_moved] + r[bytes_moved + 1:] for r in rec0]
        else:
            ref = rec0
        check(rec == ref, f"{name}: round records")
    # Conservation: every (id, state, value) row lives exactly once.
    live = [(q0.lo[l] + np.arange(q0.size[l])) % capacity
            for l in range(lanes)]
    got = {k: np.concatenate([q0.buf[k][l][r] for l, r in enumerate(live)])
           for k in items}
    order = np.argsort(got["layer"])
    for k in items:
        check(np.array_equal(got[k][order], items[k]),
              f"items not conserved ({k})")
    moved = sum(r[fields.index("n_transferred")] for r in rec0)
    check(moved > 0, "the backlog supersteps moved nothing")
    return {"lanes": lanes, "capacity": capacity, "backlog": backlog,
            "rounds": rounds, "items": int(ids.size), "moved": int(moved),
            "ms_per_superstep": {k: v[2] * 1e3 / rounds
                                 for k, v in runs.items()}}


# ----------------------------------------------- phase 3: the DD solver


def phase_solver(device, counters, *, n_items: int, seed: int,
                 n_workers: int, explore_width: int, batch: int,
                 capacity: int, max_steal: int, expect=None):
    """The solver on the kernel routing; the launch counters are zeroed
    just before the run and read just after it."""
    from repro_torch.core.dd.knapsack import dp_solve, random_instance
    from repro_torch.core.dd.parallel import parallel_solve
    from repro_torch.core.policy import StealPolicy

    inst = random_instance(n_items, seed=seed)
    policy = StealPolicy(proportion=0.5, high_watermark=4, low_watermark=0,
                         max_steal=max_steal)

    def solve():
        return parallel_solve(inst, n_workers=n_workers,
                              explore_width=explore_width, batch=batch,
                              capacity=capacity, policy=policy,
                              backend="cuda", device=device)

    for fn in counters.values():
        fn.launches = 0
    sync(device)
    t0 = time.perf_counter()
    opt, st = solve()
    sync(device)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    got = dict(optimum=opt, supersteps=st["supersteps"],
               explored=st["explored"], transferred=st["transferred"],
               steals=st["telemetry"]["steals"])
    check(opt == dp_solve(inst), f"optimum {opt} != dp_solve")
    check(st["backend"] == "cuda", f"routing {st['backend']!r} is not cuda")
    if expect is not None:
        check(got == expect, f"solver results {got} != {expect}")
    if device.type == "cuda":
        for name, n in launches.items():
            check(n > 0, f"{name} never launched on the solver path")
    t0 = time.perf_counter()
    solve()
    sync(device)
    warm = time.perf_counter() - t0
    return {**got, "launches": launches, "wall_s_first": wall,
            "wall_s": warm, "ms_per_superstep": warm * 1e3 / st["supersteps"]}


# ------------------------------------------------------------------ main


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    lib, counters = _port()
    from repro_torch.configs.paper_lfq import CONFIG

    device = torch.device("cuda")
    t0 = time.perf_counter()
    lib.library()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"built {len(lib.SOURCES)} sources in {build_s:.1f} s; card: {card}",
          flush=True)

    kernels = phase_kernels(device)
    print(json.dumps({"phase": "kernels", "result": kernels}), flush=True)
    queue = phase_queue(device, lanes=LANES, capacity=CONFIG.queue_capacity,
                        backlog=CONFIG.bench_initial_size,
                        max_steal=CONFIG.max_steal, rounds=8)
    print(json.dumps({"phase": "queue", "result": queue}), flush=True)
    solver = phase_solver(device, counters, expect=PHASE3_EXPECT, **PHASE3)
    print(json.dumps({"phase": "solver", "result": solver}), flush=True)

    rows = []
    for name, source, replaces in KERNELS:
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": solver["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
            "parity_cases": k["parity_cases"], "timed_at": k["timed_at"],
            "device_time_clean": k["device_time_clean"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
