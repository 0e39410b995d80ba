#!/usr/bin/env python3
"""Where the time of a continuous-batching decode round goes on one GPU.

Builds ``chip_smoke.py``'s phase 10 (llama3.2-1b at its published widths
and depth, bf16, random weights from seed 0, ``DecodeCluster`` on 4
stacked lanes of 8 slots, its 64-request mix arriving 16 a step) and
drains it three times: once to warm up; once timed with the host clock,
the model's ``decode_step`` wrapped in synchronised timers (its share of
a round); and once with rounds 16-31 under ``torch.profiler``.  Prints
one JSON line: ms per round (plain and with the step timers), the decode
step's ms per round, the profiled rounds' device busy time (union of
kernel intervals), idle share, launches per round, the ring kernels'
device time and launches, and the kernels that take the most device
time.

    python3 scripts/profile_decode.py [--execution host|vmap]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PROFILED = (16, 32)       # the rounds run under the profiler


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from profile_solver import device_summary
    from repro_torch.serve.decode import DecodeCluster, DecodePolicy
    from repro_torch.serve.scheduler import Request

    ap = argparse.ArgumentParser()
    ap.add_argument("--execution", default="vmap", choices=["host", "vmap"])
    args = ap.parse_args()
    dev = torch.device("cuda")
    cfg = smoke.PHASE10
    model, params = smoke._decode_model(cfg, dev)

    def drain(step=None):
        """One drain of the phase's mix; ``step(cluster)`` replaces
        ``cluster.step`` when given.  Returns (rounds, wall s)."""
        cluster = DecodeCluster(
            model, params, policy=DecodePolicy(**cfg["policy"]),
            n_lanes=cfg["n_lanes"], capacity=cfg["capacity"],
            execution=args.execution, straggler_threshold=float("inf"),
            device=dev)
        if step is not None:
            plain = cluster.step
            cluster.step = lambda: step(cluster, plain)
        reqs = smoke.decode_requests(Request, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        smoke.drive_decode(cluster, reqs, cfg["arrival"])
        torch.cuda.synchronize()
        return cluster.rounds, time.perf_counter() - t0

    drain()                                      # warm-up
    rounds, wall = drain()
    step_ms = []
    inner = model.decode_step

    def timed_decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    model.decode_step = timed_decode
    _, wall_timed = drain()
    model.decode_step = inner

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)

    def profiled(cluster, plain):
        if cluster.rounds == PROFILED[0]:
            torch.cuda.synchronize()
            prof.start()
        out = plain()
        if cluster.rounds == PROFILED[1]:
            torch.cuda.synchronize()
            prof.stop()
        return out

    drain(profiled)
    n = PROFILED[1] - PROFILED[0]
    busy_us, window_us, by_name = device_summary(prof)
    launches = sum(v[0] for v in by_name.values())
    ring = {name: [v for k, v in by_name.items() if f"{name}_kernel" in k]
            for name in ("ring_gather", "ring_scatter", "ring_slice",
                         "ring_transfer")}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "card": card, "arch": cfg["arch"], "execution": args.execution,
        "rounds": rounds, "ms_per_round": wall * 1e3 / rounds,
        "ms_per_round_with_step_timers": wall_timed * 1e3 / rounds,
        "decode_step_ms_per_round": sum(step_ms) / len(step_ms),
        "profiled_rounds": n,
        "device_busy_ms_per_round": busy_us / 1e3 / n,
        "device_window_ms_per_round": window_us / 1e3 / n,
        "device_idle_share": 1 - busy_us / window_us if window_us else None,
        "launches_per_round": launches / n,
        **{f"{name}_launches": sum(v[0] for v in vs)
           for name, vs in ring.items()},
        **{f"{name}_ms": sum(v[1] for v in vs) for name, vs in ring.items()},
        "top_kernels": [{"name": k[:80], "launches": v[0], "ms": v[1]}
                        for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
