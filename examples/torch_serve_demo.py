"""Serving on the PyTorch / CUDA port: batched requests through the
bulk-steal admission master, with a deliberate straggler replica to show
rebalancing.

  PYTHONPATH=src python examples/torch_serve_demo.py            # the GPU
  PYTHONPATH=src python examples/torch_serve_demo.py --device cpu

Reduced llama3.2-1b, random weights from seed 0.  On the GPU every
prefill's attention is the CUDA flash-attention kernel K6, one launch a
layer and wave.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._tree import resolve_device
from repro_torch.core.policy import StealPolicy
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models import build_model
from repro_torch.serve.engine import Replica, ServeCluster
from repro_torch.serve.scheduler import AdmissionMaster, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.reduced(configs.get("llama3.2-1b"))
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    reps = [Replica(model, params, wave_size=4, max_seq=64)
            for _ in range(3)]
    reps[0].speed = 0.25  # replica 0 straggles
    pol = StealPolicy(proportion=0.5, low_watermark=1, high_watermark=2)
    cluster = ServeCluster(reps, AdmissionMaster(3, policy=pol))

    rng = np.random.default_rng(0)
    reqs = [Request(prompt=list(rng.integers(1, cfg.vocab_size, 8)),
                    max_new=8) for _ in range(args.requests)]
    mha.launches = 0
    t0 = time.time()
    cluster.submit(reqs)   # ONE bulk admission (a single splice)
    done = cluster.run_until_drained()
    st = cluster.master.stats()
    print(f"[serve_demo] {len(done)}/{args.requests} requests in "
          f"{time.time() - t0:.1f}s on {device}")
    print(f"  per-replica completed: {st['completed']} (replica 0 is 4x slow)")
    print(f"  master bulk-stole {st['stolen']} requests over "
          f"{st['rounds']} rounds")
    print(f"  flash-attention kernel launches: {mha.launches}")
    sample = done[0]
    print(f"  sample output ({sample.rid}): {sample.output}")
    assert len(done) == args.requests
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
