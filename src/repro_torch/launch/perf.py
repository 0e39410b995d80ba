"""Perf variants: trace (arch, shape) under named variants and report the
three roofline terms side by side (port of ``repro.launch.perf``).

  PYTHONPATH=src python -m repro_torch.launch.perf \\
      --arch qwen3-moe-30b-a3b --shape train_4k \\
      --variants baseline,ep_moe,bf16_master,ep+bf16 \\
      --out results/perf_qwen3_train.json

Every variant is a ``ModelConfig`` switch the port runs (``moe_impl``,
``param_dtype``, ``decode_impl``, ``moe_bulk_steal``, ``remat``), traced
by ``launch.dryrun.run_cell``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict

VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "ep_moe": {"moe_impl": "ep_shardmap"},
    "bf16_master": {"param_dtype": "bfloat16"},
    "ep+bf16": {"moe_impl": "ep_shardmap", "param_dtype": "bfloat16"},
    "flash_decode": {"decode_impl": "flash_shardmap"},
    "no_steal": {"moe_bulk_steal": False},
    "no_remat": {"remat": False},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell

    rows = []
    for name in args.variants.split(","):
        variant = VARIANTS[name]
        try:
            r = run_cell(args.arch, args.shape, args.multi_pod,
                         verbose=False, variant=variant or None)
            r["variant"] = name
            rows.append(r)
            rt = r["roofline"]
            cb = r["collectives"]
            print(f"[{name:12s}] c/m/x = "
                  f"{rt['compute_s']*1e3:9.1f} / {rt['memory_s']*1e3:9.1f} / "
                  f"{rt['collective_s']*1e3:9.1f} ms   "
                  f"peak {r['memory_analysis']['peak_bytes']/2**30:6.2f} GiB  "
                  f"ag/ar/rs/a2a/cp MB = "
                  + "/".join(f"{cb.get(k,0)/2**20:.0f}" for k in
                             ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all", "collective-permute")),
                  flush=True)
        except Exception as e:
            print(f"[{name:12s}] FAILED: {type(e).__name__}: {e}", flush=True)
            rows.append({"variant": name, "status": "error",
                         "error": str(e)})
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
