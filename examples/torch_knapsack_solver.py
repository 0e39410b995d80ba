"""The paper's application on the PyTorch / CUDA port: DD-based
branch-and-bound MIP solving, from the Fig. 2 toy to a parallel
master-worker run.

  PYTHONPATH=src python examples/torch_knapsack_solver.py [--n 18] [--workers 8]
  PYTHONPATH=src python examples/torch_knapsack_solver.py --device cpu --n 10

On the GPU every explore of a batch of subproblems is one launch of the
fused DD explore, and the workers' pops and pushes and the master's
steals and splices run on the CUDA ring kernels K1-K4.
"""

import argparse
import time

import torch

from repro_torch._tree import resolve_device
from repro_torch.core.dd.bnb import solve
from repro_torch.core.dd.diagram import build_bounds
from repro_torch.core.dd.knapsack import dp_solve, paper_example, random_instance
from repro_torch.core.dd.parallel import parallel_solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--fused", type=int, default=8,
                    help="supersteps per read-back "
                         "(StealRuntime.run_fused; 1 = per-round)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "cuda"],
                    help="BulkOps queue backend for every op (master "
                         "steal/splice and worker bulk pop/push)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. the paper's running example (Eq. 1 / Figs. 2-4)
    inst = paper_example()

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    primal, dual = build_bounds(
        i32([inst.capacity]), i32([0]), i32([0]), i32(inst.weights),
        i32(inst.profits), width=3, n_vars=inst.n)
    print(f"[paper Eq.1] restricted(primal)={int(primal[0])} <= opt=15 <= "
          f"relaxed(dual)={int(dual[0])}   (Figs. 3/4 give 13 <= 15 <= 19)")
    opt, _ = solve(inst, width=4, device=device)
    print(f"[paper Eq.1] DD branch-and-bound optimum: {opt}")

    # 2. a bigger instance: sequential vs parallel master-worker
    inst = random_instance(args.n, seed=3)
    expect = dp_solve(inst)
    t0 = time.time()
    seq_opt, seq_stats = solve(inst, width=args.width, device=device)
    t_seq = time.time() - t0
    t0 = time.time()
    par_opt, par_stats = parallel_solve(inst, n_workers=args.workers,
                                        explore_width=args.width, batch=4,
                                        fused_rounds=args.fused,
                                        backend=args.backend, device=device)
    t_par = time.time() - t0
    print(f"[n={args.n}] DP oracle={expect}  sequential={seq_opt} "
          f"({seq_stats['explored']} explored, {t_seq:.1f}s)  "
          f"parallel={par_opt} ({par_stats['explored']} explored over "
          f"{args.workers} workers, {par_stats['supersteps']} supersteps "
          f"fused {args.fused}/read-back, "
          f"{par_stats['transferred']} nodes bulk-stolen, "
          f"backend={par_stats['backend']}, {t_par:.1f}s)")
    print(f"per-worker explored: {par_stats['per_worker_explored']}")
    tele = par_stats["telemetry"]
    print(f"runtime telemetry: {tele['steals']} steals moved "
          f"{tele['items_transferred']} nodes "
          f"({tele['bytes_transferred']} B) over {tele['rounds']} rounds; "
          f"adaptive proportion mean={tele['proportion_mean']:.3f} "
          f"final={tele['proportion_final']:.3f}")
    assert seq_opt == expect == par_opt
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
