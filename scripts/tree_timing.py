#!/usr/bin/env python3
"""One part of one checkout's path, timed the way ``chip_smoke.py`` times
it, for comparing two trees in one call on one card.

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and runs this checkout's ``chip_smoke.py`` code on it.  ``--part``:

- ``ring``: phase 1's ring kernel rows (K1-K4 at the solver's shapes and
  on the solver's three-leaf payload) and its Fig. 6 push-latency series
  (K2 and ``index_copy_`` at 1 to 8,192 rows a lane), phase 2 (the
  backlog supersteps) and phase 3 (the DD solver, checked against the JAX
  package's integers, with each kernel's launches: the fused explore's,
  or K5's per layer on a tree before it);
- ``ssd``: K7 (``ssd``, on whichever route the tree gives bfloat16) at
  the SSM slice's and zamba2-7b's prefill shapes, checked against the
  plain version first, then phase 5 (mamba2-2.7b serving 24 requests) and
  phase 6 (one zamba2-7b wave), with their launch and first-wave checks;
- ``resilience``: phase 8 (the fault replays held to ``PHASE8_EXPECT``,
  with their launches per round, and ms per round of the unarmed, the
  armed flat and the armed hierarchical runtime in three turns; then the
  snapshot and elastic checks).

Prints one JSON line tagged with ``--label`` and the card.  To compare a
parent commit with this one, unpack the parent into a directory that
``.gitignore`` lists and run, in turns::

    python3 scripts/tree_timing.py --part ring --src <old>/src --label parent
    python3 scripts/tree_timing.py --part ring --label change
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# K7's two serving shapes and its bfloat16 tolerance (atol, rtol), named
# here: a parent's cases.py need not have them.
SSD_SHAPES = {"slice": (4, 1024, 80, 64, 128, 256, "bfloat16"),
              "hybrid": (4, 1024, 112, 64, 64, 256, "bfloat16")}
SSD_BF16_TOL = (2e-2, 2e-2)
SERVE_KEYS = ("prefill_waves", "prefill_ms", "prefill_ms_mean",
              "prefill_shapes", "decode_steps", "decode_ms_per_step",
              "decode_ms_by_batch", "decode_ms_per_token", "tokens_per_s",
              "wall_s", "stolen", "rounds", "launches",
              "launches_tensor_core", "first_wave_f32_max_abs_err",
              "first_wave_bf16_mean_dev_from_f32")


def solver_counters() -> dict:
    """The launch counters of the solver path's kernels in the tree imported
    from ``--src``: ``dd_expand`` is the fused explore where the tree has
    it, else K5 once per layer (the trees before the fused explore)."""
    from repro_torch.kernels.dd_expand import ops as expand_ops
    from repro_torch.kernels.queue_push import ops as push_ops
    from repro_torch.kernels.queue_steal import ops as steal_ops
    from repro_torch.kernels.queue_transfer import ops as transfer_ops
    return {"ring_gather": steal_ops.steal_gather,
            "ring_scatter": push_ops.push_scatter,
            "ring_slice": push_ops.pop_slice,
            "ring_transfer": transfer_ops.transfer_splice,
            "dd_expand": getattr(expand_ops, "explore_fused",
                                 expand_ops.expand_pool)}


def ring_part(smoke, device) -> dict:
    from repro_torch.configs.paper_lfq import CONFIG

    counters = solver_counters()
    rng = np.random.default_rng(0)
    timer = smoke.Timer(device)
    kernels = smoke.kernel_timings(device, rng, timer)
    for name, row in smoke.solver_payload_timings(device, rng,
                                                  timer).items():
        kernels[name]["solver_payload"] = row
    push = smoke.push_latency(device, np.random.default_rng(1), timer)
    queue = smoke.phase_queue(device, lanes=smoke.LANES,
                              capacity=CONFIG.queue_capacity,
                              backlog=CONFIG.bench_initial_size,
                              max_steal=CONFIG.max_steal, rounds=8)
    solver = smoke.phase_solver(device, counters, expect=smoke.PHASE3_EXPECT,
                                **smoke.PHASE3)
    return {"kernels": kernels, "push_latency": push, "queue": queue,
            "solver": solver}


def ssd_part(smoke, device) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    rng = np.random.default_rng(0)
    timer = smoke.Timer(device)
    kernel = {}
    for name, shape in SSD_SHAPES.items():
        x = C.ssd_inputs(rng, shape, device)
        Q = shape[5]
        for got, want in zip(ssd(*x, chunk=Q), ssd_chunked(*x, Q)):
            smoke._close(got, want, SSD_BF16_TOL[0], f"ssd {shape}",
                         rtol=SSD_BF16_TOL[1])
        ms, clean = timer.ms(lambda: ssd(*x, chunk=Q), n=20)
        kernel[name] = {"shape": list(shape), "ms": ms,
                        "device_time_clean": clean}
    phases = {"ssd": kernel}
    for phase, fn, kw in (("serve_ssm", smoke.phase_serve, smoke.PHASE5),
                          ("wave_hybrid", smoke.phase_wave, smoke.PHASE6)):
        kw = dict(kw)
        out = fn(device, cfg=configs.get(kw.pop("arch")), **kw)
        phases[phase] = {k: out[k] for k in SERVE_KEYS if k in out}
        gc.collect()
        torch.cuda.empty_cache()
    return phases


def resilience_part(smoke, device) -> dict:
    out = smoke.phase_resilience(device, solver_counters(), smoke.PHASE8,
                                 expect=smoke.PHASE8_EXPECT)
    return {"resilience": {k: out[k] for k in ("ms_per_round", "wall_s")
                           if k in out}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("ring", "ssd", "resilience"), required=True)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    if not torch.cuda.is_available():
        print("tree_timing: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import _lib

    device = torch.device("cuda")
    _lib.library()
    part = {"ring": ring_part, "ssd": ssd_part,
            "resilience": resilience_part}[args.part](smoke, device)
    print(json.dumps({"label": args.label, "part": args.part,
                      "src": str(src), "card": smoke.card_line(), **part}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
