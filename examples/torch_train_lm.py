"""End-to-end LM training on the PyTorch / CUDA port (example application).

Default: a ~100M-parameter llama-family model for 50 steps on the
work-stealing data pipeline, with checkpoint / restart; pass
--steps / --d-model / --layers to go bigger, or use
``python -m repro_torch.launch.train --preset full`` for the assigned
configs.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 50      # the GPU
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
      --steps 4 --layers 2 --d-model 256 --vocab 512 --seq 32

On the GPU the forward's attention is the CUDA flash-attention kernel K6,
one launch a layer and step (its backward recomputes the plain version).
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch._tree import resolve_device, tree_leaves
from repro_torch.data.pipeline import WorkStealingPipeline
from repro_torch.data.synthetic import synth_batch
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ~100M params at the defaults (12L, d=768, v=32k: ~110M).
    cfg = dataclasses.replace(
        configs.get("llama3.2-1b"),
        name="llama-100m", n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 256,
        head_dim=64, d_ff=args.d_model * 4, vocab_size=args.vocab,
        tie_embeddings=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq} "
          f"on {device}")

    opt = adamw_init(params)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    pipe = WorkStealingPipeline(
        n_hosts=1,
        make_batch=lambda shard, step: synth_batch(
            0, shard, step, args.batch, args.seq, cfg.vocab_size))

    start = 0
    if ckpt_lib.latest_step(args.ckpt_dir):
        (params, opt), start, _ = ckpt_lib.restore(
            args.ckpt_dir, (params, opt), device=device)
        print(f"[train_lm] resumed from step {start}")

    mha.launches = 0
    for step in range(start, args.steps):
        raw = pipe.next_batch(0)
        batch = {k: torch.from_numpy(raw[k]).to(device)
                 for k in ("tokens", "labels")}
        params, opt, m = step_fn(params, opt, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"  step {step:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if (step + 1) % 50 == 0:
            ckpt_lib.save(args.ckpt_dir, step + 1, (params, opt))
    print(f"[train_lm] flash-attention kernel launches: {mha.launches}")
    print("[train_lm] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
