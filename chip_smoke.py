#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port only (``src/repro_torch``; it imports neither JAX nor
the JAX package) and fails — non-zero exit, no result line — on the first
check that does not hold:

1. Build and kernel parity.  Builds the CUDA kernels from the checkout's
   sources (``repro_torch.kernels._lib``).  Holds each ring kernel (K1-K4)
   against its plain PyTorch version bit for bit — on the kernel case
   tables and at the solver's geometry (64 lanes, 16,384-row rings,
   max_steal 8,192, 128-row pushes, 8-row pops) in float32, int32 and
   bfloat16 — and flash attention (K6) within the JAX package's
   tolerances (2e-5 float32, 2e-2 bfloat16) on its case tables and at
   the serving slice's prefill shape (B 4, S = T 1,024, 32 heads over 8
   KV heads of 64, bfloat16, causal).  Times kernel, plain version and a
   library yardstick (``index_select`` / ``index_copy_``; SDPA for K6)
   with CUDA events.
2. The queue at the paper's backlog.  64 lanes of 16,384 rows, half of
   them holding 10,000 seeded unique items; 8 rebalancing supersteps on the
   kernel backend under the compact and the dense exchange and on the
   reference backend.  Rings, cursors and round records must agree across
   the three runs, and every item must survive exactly once.
3. The DD solver at full size.  ``parallel_solve`` on a 30-item knapsack
   with 64 workers; it must reproduce the JAX package's integer results,
   and each of the four ring kernels must have launched during that run.
4. Serving at full width.  The wave engine (two replicas, one at a
   quarter speed, behind the bulk-steal admission master) serves 24
   requests of 128-1,024 prompt tokens and 16 new tokens each with
   llama3.2-1b at its published widths and random weights from seed 0.
   Every request must be served in full, the master must have stolen,
   K6 must have launched once per layer and prefill wave, and the first
   wave's prefill logits must agree with the same prefill through K6's
   plain version (swapped in for that one call): within 1e-4 in float32
   compute, and in the run's bfloat16 compute as close to the float32
   logits as the plain version's (mean distance at most 1.1x).

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

# Phase 4: the repo's default serving arch (launch/serve.py) at full
# width; the two-replica straggler setup of examples/serve_demo.py.
PHASE4 = dict(arch="llama3.2-1b", n_requests=24, prompt_lens=(128, 1024),
              max_new=16, max_seq=1040, wave_size=4, slow_speed=0.25)
# The first wave's prefill through K6 against the same prefill through its
# plain version.  In float32 compute they must agree to 1e-4 (the port's
# float32 logits tolerance against the JAX package).  In bfloat16 compute
# at this width two correct attentions that round differently already
# differ by more than tests/test_serve.py's 2e-2 (see
# scripts/prefill_precision.py: the plain version's own bf16 logits sit
# 0.11 from its float32 ones), so there K6 must be as accurate as its
# plain version: its mean distance from the float32 logits at most 1.1x
# the plain's.
SERVE_TOL_F32 = 1e-4
SERVE_TOL_BF16 = 2e-2  # reported: share of logits outside it
SERVE_BF16_RATIO = 1.1

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)

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
    ("flash_attention",
     "src/repro_torch/kernels/flash_attention/flash_attention.cu",
     "src/repro/kernels/flash_attention/kernel.py:100"),
)
RING_KERNELS = tuple(k[0] for k in KERNELS[:4])


def _port():
    """The port's modules (imported late: the script must fail cleanly
    where there is no GPU or no checkout around it)."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels._lib as lib
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.queue_push import ops as push_ops
    from repro_torch.kernels.queue_steal import ops as steal_ops
    from repro_torch.kernels.queue_transfer import ops as transfer_ops
    return lib, {"ring_gather": steal_ops.steal_gather,
                 "ring_scatter": push_ops.push_scatter,
                 "ring_slice": push_ops.pop_slice,
                 "ring_transfer": transfer_ops.transfer_splice,
                 "flash_attention": flash_ops.mha}


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
                         bound_by="bytes", bound_bytes=nbytes, timed_at=what,
                         device_time_clean=clean and plain_clean)
    return out


def _flash_inputs(device, rng, case):
    from repro_torch.kernels import cases as C
    B, S, T, H, K, hd, _, _, _, dtype = case
    return [C.to_tensor(C.payload(rng, shape, dtype), dtype, device)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


def _close(kernel_out, plain_out, tol: float, what: str) -> float:
    """``|kernel - plain| <= tol + tol * |plain|`` everywhere (the JAX
    package's assert_allclose); returns the max abs difference."""
    import torch
    check(kernel_out.shape == plain_out.shape
          and kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype")
    a, b = kernel_out.float(), plain_out.float()
    diff = (a - b).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = torch.isfinite(a).all() and (diff <= tol + tol * b.abs()).all()
    check(bool(ok), f"{what}: kernel differs from its plain version (max "
                    f"abs err {err}, tolerance {tol})")
    return err


def flash_checks(device, rng, shape):
    """K6 against its plain version on the case tables and at ``shape``;
    returns (max abs err, number of cases)."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref

    err, cases = 0.0, C.FLASH_CASES + C.FLASH_EXTRA_CASES + [shape]
    for case in cases:
        B, S, T, H, K, hd, causal, window, cap, dtype = case
        q, k, v = _flash_inputs(device, rng, case)
        kw = dict(causal=causal, window=window, softcap=cap)
        err = max(err, _close(mha(q, k, v, **kw), attention_ref(q, k, v, **kw),
                              C.FLASH_TOL[dtype], f"flash_attention {case}"))
    return err, len(cases)


def flash_timing(device, rng, timer, shape):
    """K6, its plain version and SDPA (checked equal within tolerance
    first) at ``shape``, and the bound: the larger of 4 hd flops per
    visible (q, k) pair per head at the dense bf16 tensor-core peak and
    q, k, v and o's bytes at the memory rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref, visible

    B, S, T, H, K, hd, causal, window, cap, dtype = shape
    check(causal and S == T and window is None and cap is None,
          "SDPA's is_causal computes K6's function only for causal S == T")
    q, k, v = _flash_inputs(device, rng, shape)
    kw = dict(causal=causal, window=window, softcap=cap)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    _close(library(), mha(q, k, v, **kw), C.FLASH_TOL[dtype],
           "SDPA yardstick vs flash_attention")
    pairs = int(visible(S, T, causal=causal, window=window).sum())
    flops = 4 * B * H * hd * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ms, clean = timer.ms(lambda: mha(q, k, v, **kw))
    plain_ms, plain_clean = timer.ms(lambda: attention_ref(q, k, v, **kw),
                                     n=20)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=timer.ms(library)[0],
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes",
                bound_flops=flops, bound_bytes=nbytes,
                timed_at=f"B {B}, S {S}, T {T}, H {H}, K {K}, hd {hd}, "
                         f"{dtype}, causal",
                device_time_clean=clean and plain_clean)


def phase_kernels(device, seed: int = 0, flash_shape=None):
    """Every kernel against its plain version, then timed.  ``flash_shape``
    is K6's timed shape (default: the serving slice's prefill)."""
    from repro_torch.kernels import cases as C
    rng = np.random.default_rng(seed)
    errs, counts = {}, {}
    for name, what, k_out, p_out in kernel_cases(device, rng):
        errs[name] = max(errs.get(name, 0.0),
                         _compare(k_out, p_out, f"{name} {what}"))
        counts[name] = counts.get(name, 0) + 1
    flash_shape = flash_shape or C.FLASH_SLICE
    errs["flash_attention"], counts["flash_attention"] = flash_checks(
        device, rng, flash_shape)
    sync(device)
    timer = Timer(device)
    timings = kernel_timings(device, rng, timer)
    timings["flash_attention"] = flash_timing(device, rng, timer, flash_shape)
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
    """The solver on the kernel routing; the ring kernels' launch
    counters are zeroed just before the run and read just after it."""
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

    counters = {name: counters[name] for name in RING_KERNELS}
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


# --------------------------------------------------- phase 4: serving


def phase_serve(device, mha, *, cfg, n_requests: int, prompt_lens,
                max_new: int, max_seq: int, wave_size: int,
                slow_speed: float, seed: int = 0):
    """The wave engine behind the admission master, with ``mha`` (K6's
    wrapper) counting its launches from just before the run to just after
    it; then the first wave's prefill once more with K6's plain version
    swapped in, to compare logits."""
    import torch
    from repro_torch.core.policy import StealPolicy
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.engine import Replica, ServeCluster
    from repro_torch.serve.scheduler import AdmissionMaster, Request

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    sync(device)
    init_s = time.perf_counter() - t0

    prefill_ms, decode_ms, first = [], [], []
    prefill, decode = model.prefill, model.decode_step

    def timed_prefill(p, tokens):
        sync(device)
        t = time.perf_counter()
        logits, cache = prefill(p, tokens)
        sync(device)
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        if not first:
            first.append((tokens.clone(), logits.clone()))
        return logits, cache

    def timed_decode(p, cache, tokens):
        sync(device)
        t = time.perf_counter()
        out = decode(p, cache, tokens)
        sync(device)
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    model.prefill, model.decode_step = timed_prefill, timed_decode
    reps = [Replica(model, params, wave_size=wave_size, max_seq=max_seq)
            for _ in range(2)]
    reps[0].speed = slow_speed
    master = AdmissionMaster(2, StealPolicy(proportion=0.5, low_watermark=1,
                                            high_watermark=2))
    cluster = ServeCluster(reps, master)
    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    reqs = [Request(prompt=[int(t) for t in rng.integers(1, cfg.vocab_size,
                                                         int(n))],
                    max_new=max_new) for n in lens]

    mha.launches = 0
    sync(device)
    t0 = time.perf_counter()
    cluster.submit(reqs)
    done = cluster.run_until_drained()
    sync(device)
    wall = time.perf_counter() - t0
    launches = mha.launches
    model.prefill, model.decode_step = prefill, decode

    st = master.stats()
    tokens = sum(len(r.output or []) for r in done)
    check(len(done) == n_requests, f"served {len(done)} of {n_requests}")
    check(all(len(r.output) == max_new for r in done),
          f"a request got fewer than {max_new} tokens")
    check(sum(st["completed"]) == n_requests,
          f"master completed {st['completed']}")
    check(st["stolen"] > 0, "the master never stole")
    if device.type == "cuda":
        check(launches == cfg.n_layers * len(prefill_ms),
              f"flash_attention launched {launches} times for "
              f"{len(prefill_ms)} prefill waves of {cfg.n_layers} layers")

    tokens0, logits0 = first[0]
    first_wave = first_wave_check(cfg, params, tokens0, logits0, mha)
    decode_total = sum(decode_ms)
    return {
        "arch": cfg.name, "params": cfg.param_count(), "init_s": init_s,
        "requests": len(done), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefill_waves": len(prefill_ms),
        "prefill_ms": prefill_ms,
        "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
        "prefill_share": sum(prefill_ms) / (wall * 1e3),
        "decode_steps": len(decode_ms),
        "decode_ms_per_step": decode_total / len(decode_ms),
        "decode_ms_per_token": decode_total / tokens,
        "prompt_tokens": int(lens.sum()),
        "first_wave_shape": list(tokens0.shape), **first_wave,
        "stolen": st["stolen"], "rounds": st["rounds"],
        "completed": st["completed"], "flash_launches": launches}


def first_wave_check(cfg, params, tokens, logits_k6, mha):
    """The first wave's last-position prefill logits through K6 against
    the same prefill with K6's plain version swapped in (no switch in the
    package), in the run's bfloat16 compute and in float32 compute."""
    import dataclasses
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.zoo import build_model

    bf16, f32 = build_model(cfg), build_model(
        dataclasses.replace(cfg, compute_dtype="float32"))
    out = {}
    for route, fn in (("plain", attention_ref), ("k6", mha)):
        flash_ops.mha = fn
        try:
            if route == "plain":
                out["bf16/plain"] = bf16.prefill(params, tokens)[0]
            out[f"f32/{route}"] = f32.prefill(params, tokens)[0]
        finally:
            flash_ops.mha = mha
    f32_err = _close(out["f32/k6"], out["f32/plain"], SERVE_TOL_F32,
                     "first wave, float32 compute: K6 vs its plain version")
    k6, plain, ref = logits_k6.double(), out["bf16/plain"].double(), \
        out["f32/plain"].double()
    dev_k6 = float((k6 - ref).abs().mean())
    dev_plain = float((plain - ref).abs().mean())
    check(dev_k6 <= SERVE_BF16_RATIO * dev_plain,
          f"first wave, bfloat16 compute: K6's logits sit {dev_k6} from the "
          f"float32 ones on average, its plain version's {dev_plain}")
    diff = (k6 - plain).abs()
    return {
        "first_wave_f32_max_abs_err": f32_err,
        "first_wave_bf16_max_abs_err": float(diff.max()),
        "first_wave_bf16_outside_2e-2": float(
            (diff > SERVE_TOL_BF16 * (1 + plain.abs())).double().mean()),
        "first_wave_bf16_mean_dev_from_f32": {"k6": dev_k6,
                                              "plain": dev_plain},
        "first_wave_greedy_agreement": float(
            (k6.argmax(-1) == plain.argmax(-1)).double().mean())}


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
    from repro_torch import configs
    serve_kw = dict(PHASE4)
    serve = phase_serve(device, counters["flash_attention"],
                        cfg=configs.get(serve_kw.pop("arch")), **serve_kw)
    print(json.dumps({"phase": "serve", "result": serve}), flush=True)

    launches = {**solver["launches"],
                "flash_attention": serve["flash_launches"]}
    rows = []
    for name, source, replaces in KERNELS:
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
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
