"""Serving entry point: N replicas + bulk-steal admission master (port of
``repro.launch.serve``, wave engine).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --replicas 2 --requests 24

It serves the reduced (smoke-test) variant of ``--arch`` with random
parameters from seed 0, on the GPU unless ``--device cpu`` is given.
``--decode`` (the continuous-batching decode engine) waits for the decode
slice and raises; ``--execution`` and ``--steal`` belong to it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._tree import resolve_device
from repro_torch.models.zoo import build_model
from repro_torch.serve.engine import Replica, ServeCluster
from repro_torch.serve.scheduler import AdmissionMaster, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=list(configs.ARCH_IDS))
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--straggle", action="store_true",
                    help="make replica 0 slow to show bulk-steal rebalancing")
    ap.add_argument("--decode", action="store_true",
                    help="continuous-batching decode engine instead of waves")
    ap.add_argument("--execution", default="vmap",
                    choices=["host", "vmap", "mesh"],
                    help="(--decode) where the rebalancing master runs")
    ap.add_argument("--steal", default="queue", choices=["queue", "migrate"],
                    help="(--decode) steal only KV-free queued requests, or "
                         "also migrate in-flight sequences with their pages")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run there)")
    args = ap.parse_args(argv)

    if args.decode:
        raise NotImplementedError(
            "--decode (serve/decode.py with paged KV) waits for the decode "
            "slice of the port")
    device = resolve_device(args.device)
    cfg = configs.reduced(configs.get(args.arch))
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("serve demo targets decoder-family archs")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    rng = np.random.default_rng(0)
    reps = [Replica(model, params, wave_size=4, max_seq=64)
            for _ in range(args.replicas)]
    if args.straggle and reps:
        reps[0].speed = 0.25
    cluster = ServeCluster(reps, AdmissionMaster(args.replicas))

    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab_size, size=8)),
                    max_new=args.max_new) for _ in range(args.requests)]
    t0 = time.time()
    cluster.submit(reqs)
    done = cluster.run_until_drained()
    dt = time.time() - t0
    st = cluster.master.stats()
    toks = sum(len(r.output or []) for r in done)
    print(f"[serve] {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s on {device}")
    print(f"[serve] per-replica completed={st['completed']} "
          f"stolen={st['stolen']} rounds={st['rounds']}")
    if len(done) != args.requests:
        raise RuntimeError(f"served {len(done)} of {args.requests} requests")
    return 0


if __name__ == "__main__":
    main()
