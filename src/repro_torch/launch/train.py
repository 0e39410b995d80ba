"""End-to-end training entry point (port of ``repro.launch.train``).

Trains a config for real (``--preset smoke``: the reduced config;
``--preset full``: the published widths) on the GPU, or on the CPU with
``--device cpu``.  Fault tolerance as in the JAX package: atomic
checkpoints of ``(params, opt)`` every ``--ckpt-every`` steps and at the
end, a final checkpoint on SIGTERM / SIGINT (``GracefulExit``), restart
from the latest checkpoint on a crash (``run_supervised``), and the
work-stealing data pipeline over ``synth_batch``.  A checkpoint also holds
the data step, and a resumed run (a restart, or a new process pointed at
the same ``--ckpt-dir``) skips the pipeline to it, so it draws the batches
an uninterrupted run would have drawn.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch llama3.2-1b --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ck
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch import configs
from repro_torch._tree import resolve_device
from repro_torch.data.pipeline import WorkStealingPipeline
from repro_torch.data.synthetic import synth_batch
from repro_torch.models.zoo import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import (GracefulExit, StragglerMonitor,
                                     run_supervised)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step

__all__ = ["build", "make_batch", "main"]


def build(arch: str, preset: str):
    cfg = configs.get(arch)
    if preset == "smoke":
        cfg = configs.reduced(cfg)
    return cfg, build_model(cfg)


def make_batch(cfg, raw: dict, device) -> dict:
    """A training batch on ``device`` from the pipeline's numpy tokens and
    labels; the VLM family gets zero patches and the enc-dec family frames
    of ones, as long as the tokens (their stub frontends, as in the JAX
    package's launcher)."""
    batch = {k: torch.from_numpy(raw[k]).to(device)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patches"] = torch.zeros(
            (raw["tokens"].shape[0], cfg.n_patches, cfg.frontend_dim),
            dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        B, S = raw["tokens"].shape
        batch["frames"] = torch.ones((B, S, cfg.frontend_dim),
                                     dtype=torch.float32, device=device)
    return batch


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, model = build(args.arch, args.preset)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 1))
    train_step = make_train_step(model, opt_cfg, microbatch=args.microbatch)

    def run(resume) -> int:
        pipeline = WorkStealingPipeline(
            n_hosts=1,
            make_batch=lambda shard, step: synth_batch(
                args.seed, shard, step, args.batch, args.seq,
                cfg.vocab_size))
        params = model.init(
            torch.Generator(device=device).manual_seed(args.seed))
        opt = adamw_init(params)
        start = 0
        if args.ckpt_dir and (resume is not None
                              or ckpt_lib.latest_step(args.ckpt_dir)):
            try:
                (params, opt), start, extra = ckpt_lib.restore(
                    args.ckpt_dir, (params, opt), device=device)
            except FileNotFoundError:
                pass
            else:
                for _ in range(extra.get("data", {}).get("step", 0)):
                    pipeline.queues[0].pop()
                print(f"[train] resumed from step {start}")

        mon = StragglerMonitor()
        with GracefulExit() as stop:
            for step in range(start, args.steps):
                mon.start()
                batch = make_batch(cfg, pipeline.next_batch(0), device)
                params, opt, metrics = train_step(params, opt, batch)
                mon.observe()
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(f"[train] step {step} "
                          f"loss {float(metrics['loss']):.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"lr {float(metrics['lr']):.2e}")
                if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                      or stop.requested
                                      or step == args.steps - 1):
                    ckpt_lib.save(args.ckpt_dir, step + 1, (params, opt),
                                  extra={"data": {"step": step + 1}})
                if stop.requested:
                    print("[train] SIGTERM: checkpointed and exiting")
                    return step + 1
        print(f"[train] done at step {args.steps}; "
              f"pipeline stats {pipeline.stats()}")
        return args.steps

    return run_supervised(run, max_restarts=2)


if __name__ == "__main__":
    main()
