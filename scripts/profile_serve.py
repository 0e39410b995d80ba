#!/usr/bin/env python3
"""Where the time of one serving wave goes on one GPU.

Builds ``--arch`` (default llama3.2-1b, the model ``chip_smoke.py`` phase
4 serves; mamba2-2.7b is phase 5's, zamba2-7b phase 6's) at its published
widths and depth with random weights from seed 0 and runs one wave the
way ``serve.engine.Replica`` does: a 4 x 1,024-token prefill, the cache
grown to 1,040 positions, 16 greedy decode steps.  After a warm-up wave it
times the prefill and the decode steps with the host clock (each ending
in a synchronize), then runs the same under ``torch.profiler``.  Prints
one JSON line per part (prefill, decode): wall ms, the device's busy time
(union of kernel intervals) and idle share, the kernel launches, the
device time and launches of flash attention (K6) and the SSD scan (K7),
and the kernels that take the most device time.

    python3 scripts/profile_serve.py [--arch mamba2-2.7b]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_SEQ, STEPS = 4, 1024, 1040, 16


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from profile_solver import device_summary
    from repro_torch import configs
    from repro_torch.models.zoo import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(configs.ARCH_IDS))
    dev = torch.device("cuda")
    cfg = configs.get(ap.parse_args().arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, S)), dtype=torch.int32, device=dev)

    def prefill():
        logits, cache = model.prefill(params, toks)
        cache = model.grow_cache(cache, MAX_SEQ)
        torch.cuda.synchronize()
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    def decode(cur, cache):
        for _ in range(STEPS):
            cur.tolist()  # the engine reads each step's tokens on the host
            logits, cache = model.decode_step(params, cache, cur[:, None])
            cur = logits[:, -1].argmax(-1).to(torch.int32)
        torch.cuda.synchronize()

    decode(*prefill())  # warm-up wave
    t0 = time.perf_counter()
    cur, cache = prefill()
    walls = {"prefill": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    decode(cur, cache)
    walls["decode"] = (time.perf_counter() - t0) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profs = {}
    with torch.profiler.profile(activities=acts) as profs["prefill"]:
        cur, cache = prefill()
    with torch.profiler.profile(activities=acts) as profs["decode"]:
        decode(cur, cache)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for part, prof in profs.items():
        busy_us, window_us, by_name = device_summary(prof)
        launches = sum(v[0] for v in by_name.values())
        # K6's and K7's tensor-core (bf16) and SIMT (float32) kernels
        ours = {name: [v for k, v in by_name.items()
                       if any(kernel in k for kernel in kernels)]
                for name, kernels in (
                    ("flash_attention", ("flash_wgmma_kernel",
                                         "flash_kernel")),
                    ("ssd_scan", ("ssd_kernel", "ssd_state_kernel",
                                  "ssd_output_kernel")))}
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        steps = STEPS if part == "decode" else 1
        print(json.dumps({
            "card": card, "arch": cfg.name, "part": part, "batch": B,
            "prompt": S,
            "steps": steps, "wall_ms": walls[part],
            "wall_ms_per_step": walls[part] / steps,
            "device_busy_ms": busy_us / 1e3,
            "device_window_ms": window_us / 1e3,
            "device_idle_share": 1 - busy_us / window_us if window_us
            else None,
            "kernel_launches": launches,
            "launches_per_step": launches / steps,
            **{f"{name}_launches": sum(v[0] for v in vs)
               for name, vs in ours.items()},
            **{f"{name}_ms": sum(v[1] for v in vs)
               for name, vs in ours.items()},
            "top_kernels": [{"name": k[:80], "launches": v[0], "ms": v[1]}
                            for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
