"""Quickstart on the PyTorch / CUDA port: the lock-free bulk work-stealing
queue, three ways.

  PYTHONPATH=src python examples/torch_quickstart.py            # the GPU
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the GPU the device queue's bulk push is one launch of the CUDA ring
kernel K2 and its bulk steal one of K1; the master's superstep reads
every lane's window with K1 and splices with K4.  On the CPU the same
calls run the kernels' plain versions and launch nothing.
"""

import argparse

import torch

from repro_torch._tree import resolve_device
from repro_torch.core.host_queue import LinkedWSQueue, llist_from_iter
from repro_torch.core.ops import make_ops, make_queue
from repro_torch.core.policy import StealPolicy
from repro_torch.core.sharded_queue import (make_sharded_queues,
                                            vmapped_superstep)
from repro_torch.kernels.queue_push.ops import push_scatter
from repro_torch.kernels.queue_steal.ops import steal_gather
from repro_torch.kernels.queue_transfer.ops import transfer_splice

KERNELS = {"ring_gather": steal_gather, "ring_scatter": push_scatter,
           "ring_transfer": transfer_splice}


def launches() -> str:
    return " ".join(f"{name}={fn.launches}" for name, fn in KERNELS.items())


def reset() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -- 1. the paper's queue, faithful host port (Listings 1-4) ------------
    q = LinkedWSQueue()
    q.push(llist_from_iter(range(10)))        # bulk push: ONE splice
    print("owner pops newest:", q.pop())       # LIFO owner side
    begin, end, count = q.steal(0.5)           # master steals the tail suffix
    print(f"stealer got {count} oldest nodes; {len(q)} remain")

    # -- 2. the device ring queue behind a BulkOps backend ------------------
    # "auto" is the CUDA ring kernels' routing; swap it for "reference" to
    # pin the plain PyTorch version.
    ops = make_ops("auto", capacity=64, max_steal=32)
    print("backend:", ops, "->", ops.resolved, "on", device)
    reset()
    state = make_queue(64, torch.zeros((), dtype=torch.int32), device=device)
    state, _ = ops.push(state, torch.arange(16, dtype=torch.int32,
                                            device=device),
                        torch.tensor(16, dtype=torch.int32, device=device),
                        donate=True)
    state, item, ok = ops.pop(state)
    print("device pop:", int(item), "valid:", bool(ok))
    state, batch, n = ops.steal(state, 0.5, max_steal=32)
    print("device bulk steal:", int(n), "items; size now", int(state.size))
    print("queue kernel launches:", launches())

    # -- 3. the virtual master: one rebalancing superstep over the lanes ---
    policy = StealPolicy(proportion=0.5, high_watermark=4, low_watermark=1,
                         max_steal=16, backend="auto")
    qs = make_sharded_queues(4, 64, torch.zeros((), dtype=torch.int32),
                             device=device)
    # worker 0 overloaded, the others empty
    seed = torch.arange(16, dtype=torch.int32, device=device)[None].repeat(
        4, 1)
    ns = torch.tensor([16, 0, 0, 0], dtype=torch.int32, device=device)
    qs, _ = ops.push(qs, seed, ns)
    step = vmapped_superstep(policy, ops, device=device)
    reset()
    qs2, stats = step(qs)
    print("sizes before:", qs.size.tolist(),
          "after one master superstep:", qs2.size.tolist())
    print(f"superstep moved {int(stats.n_transferred[0])} items in "
          f"{int(stats.n_steals[0])} steals")
    print("superstep kernel launches:", launches())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
