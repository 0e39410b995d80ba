#!/usr/bin/env python3
"""Where the time of one training step goes on one GPU.

Builds ``--arch`` (default llama3.2-1b, which ``chip_smoke.py`` phase 11
trains; seamless-m4t-medium is phase 12's) at its published widths and
depth with random float32 weights from seed 0, bf16 compute, and takes
``make_train_step``'s parts on the first 4 x 1,024 batch of
``launch/train``'s pipeline (an enc-dec batch's frames drawn from the
seed, as phase 12 draws them), each timed with the host
clock between synchronizes after a warm-up step: the forward and loss
alone, the forward and backward (``value_and_grad``), AdamW, and within
the backward the plain attention backward that K6's launches carry
(``kernels/_backward.plain_grads``, synchronized around each call).  The
same with remat off, for what the recompute costs.  Then one whole step
under ``torch.profiler``: device busy time and idle share, launches, K6's
launches and device time, and the kernels that take the most.  Prints
one JSON line.

    python3 scripts/profile_train.py [--arch seamless-m4t-medium]
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S, REPEAT = 4, 1024, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from profile_solver import device_summary
    from repro_torch import configs
    from repro_torch.data.pipeline import WorkStealingPipeline
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.train import make_batch
    from repro_torch.models.zoo import build_model
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             adamw_update)
    from repro_torch.train.trainer import make_train_step, value_and_grad

    dev = torch.device("cuda")
    cfg = configs.get(args.arch)
    pipeline = WorkStealingPipeline(1, make_batch=lambda shard, step:
                                    synth_batch(0, shard, step, B, S,
                                                cfg.vocab_size))
    batch = make_batch(cfg, pipeline.next_batch(0), dev)
    if "frames" in batch:  # ones would leave the encoder one position
        batch["frames"] = torch.randn(
            batch["frames"].shape, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
    params = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)

    backward = {"ms": 0.0, "calls": 0}
    real_plain_grads = flash_ops.plain_grads

    def timed_plain_grads(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_plain_grads(*args, **kwargs)
        torch.cuda.synchronize()
        backward["ms"] += (time.perf_counter() - t) * 1e3
        backward["calls"] += 1
        return out

    def ms(fn):
        """Mean host ms of ``fn`` over REPEAT calls after one warm-up."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(REPEAT):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / REPEAT

    def settle(tag):
        """Free what the last part left and record what stays allocated
        (the parameters' 4.6 GiB and the batch)."""
        gc.collect()
        torch.cuda.empty_cache()
        parts[f"{tag}_held_gb"] = torch.cuda.memory_allocated() / 2 ** 30

    parts = {}
    model = build_model(cfg)
    _, grads = value_and_grad(model.loss_fn, params, batch)
    opt = adamw_init(params)
    parts["adamw_ms"] = ms(lambda: adamw_update(opt_cfg, grads, opt, params))
    del grads, opt
    settle("after_adamw")
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg, remat=remat))
        tag = "remat" if remat else "no_remat"

        def forward():
            with torch.enable_grad():
                model.loss_fn(params, batch)

        parts[f"{tag}_forward_ms"] = ms(forward)
        parts[f"{tag}_forward_backward_ms"] = ms(
            lambda: value_and_grad(model.loss_fn, params, batch))
        flash_ops.plain_grads = timed_plain_grads
        backward.update(ms=0.0, calls=0)
        value_and_grad(model.loss_fn, params, batch)
        flash_ops.plain_grads = real_plain_grads
        parts[f"{tag}_attention_backward_ms"] = backward["ms"]
        parts[f"{tag}_attention_backward_calls"] = backward["calls"]
        settle(f"{tag}_before_steps")
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(model, opt_cfg)
        opt = adamw_init(params)
        parts[f"{tag}_step_ms"] = ms(lambda: step(params, opt, batch))
        parts[f"{tag}_peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del step, opt
        settle(f"{tag}_after_steps")

    model = build_model(cfg)
    opt = adamw_init(params)
    step = make_train_step(model, opt_cfg)
    step(params, opt, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = flash_ops.mha.launches
    with torch.profiler.profile(activities=acts) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    k6_calls = flash_ops.mha.launches - before
    busy_us, window_us, by_name = device_summary(prof)
    k6 = [v for k, v in by_name.items() if "flash_wgmma_kernel" in k]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "card": card, "arch": cfg.name, "batch": [B, S], **parts,
        "profiled_step": {
            "device_busy_ms": busy_us / 1e3,
            "device_window_ms": window_us / 1e3,
            "device_idle_share": 1 - busy_us / window_us if window_us
            else None,
            "kernel_launches": sum(v[0] for v in by_name.values()),
            "flash_attention_calls": k6_calls,
            "flash_attention_launches": sum(v[0] for v in k6),
            "flash_attention_ms": sum(v[1] for v in k6),
            "top_kernels": [{"name": k[:80], "launches": v[0], "ms": v[1]}
                            for k, v in top]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
