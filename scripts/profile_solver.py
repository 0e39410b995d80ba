#!/usr/bin/env python3
"""Where the time of the full-size DD solver goes on one GPU.

Runs ``repro_torch.core.dd.parallel.parallel_solve`` on the configuration
``chip_smoke.py`` checks (30-item knapsack, seed 3, 64 workers, rings of
16,384 rows, max_steal 8,192) on the kernel routing: once to warm up, once
timed, once under ``torch.profiler``.  Prints one JSON line with the wall
time per superstep, the device's busy time (union of kernel intervals) and
idle share, the kernel launches per superstep, the ring kernels' share of
device time and the kernels that take the most device time.

    python3 scripts/profile_solver.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RING_KERNELS = ("ring_gather_kernel", "ring_scatter_kernel",
                "ring_slice_kernel", "ring_transfer_kernel")


def device_summary(prof):
    """``(busy us, window us, {kernel name: [launches, ms]})`` of the
    device events in a ``torch.profiler`` run: busy is the union of the
    kernel intervals, window the span from the first start to the last
    end."""
    import torch
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name][0] += 1
        by_name[e.name][1] += (end - start) / 1e3  # us -> ms
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    window_us = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return busy_us, window_us, by_name


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_solver: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.dd.knapsack import random_instance
    from repro_torch.core.dd.parallel import parallel_solve
    from repro_torch.core.policy import StealPolicy

    inst = random_instance(30, seed=3)
    policy = StealPolicy(proportion=0.5, high_watermark=4, low_watermark=0,
                         max_steal=8192)

    def solve():
        out = parallel_solve(inst, n_workers=64, explore_width=16, batch=8,
                             capacity=16384, policy=policy, backend="cuda")
        torch.cuda.synchronize()
        return out

    solve()
    t0 = time.perf_counter()
    opt, st = solve()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve()
        prof_wall = time.perf_counter() - t0

    busy_us, window_us, by_name = device_summary(prof)
    n_launches = sum(v[0] for v in by_name.values())
    kernel_ms = sum(v[1] for v in by_name.values())
    ring_ms = sum(v[1] for k, v in by_name.items()
                  if any(r in k for r in RING_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    steps = st["supersteps"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "card": card, "optimum": opt, "supersteps": steps,
        "wall_s": wall, "ms_per_superstep": wall * 1e3 / steps,
        "profiled_wall_s": prof_wall,
        "device_busy_ms": busy_us / 1e3,
        "device_window_ms": window_us / 1e3,
        "device_idle_share": 1 - busy_us / window_us if window_us else None,
        "kernel_launches": n_launches,
        "launches_per_superstep": n_launches / steps,
        "kernel_ms": kernel_ms,
        "ring_kernel_ms": ring_ms,
        "top_kernels": [{"name": k[:80], "launches": v[0], "ms": v[1]}
                        for k, v in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
