#!/usr/bin/env python3
"""How far the serving model's prefill logits move when K6 (flash
attention) is swapped for its plain version, beside how far bfloat16
compute moves them from float32 compute.

Builds llama3.2-1b at its published widths with random weights from seed
0 on the GPU (the model ``chip_smoke.py`` phase 4 serves) and runs one
prefill of the first prompt that phase serves (1 x 130 tokens, the wave
replica 0 takes first) and one of a 4 x 1,024 wave of random prompts, each
four ways: bfloat16 or float32 compute, through K6 or through its plain
version.  Prints one JSON line per wave: for each pair, the max, mean and
99.9th-percentile absolute difference of the last-position logits, the
share of logits outside ``atol = rtol = 2e-2`` and the greedy (argmax)
agreement.

    python3 scripts/prefill_precision.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-2


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("prefill_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.zoo import build_model

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = configs.get("llama3.2-1b")
    # chip_smoke.py phase 4's draw: the last of its 24 requests is the one
    # replica 0 pops first.
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 1025, 24)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)) for n in lens]
    waves = {"first_wave": torch.tensor(prompts[-1][None], dtype=torch.int32),
             "wave_4x1024": torch.tensor(np.random.default_rng(1).integers(
                 1, cfg.vocab_size, (4, 1024)), dtype=torch.int32)}
    mha = flash_ops.mha
    for name, toks in waves.items():
        logits = {}
        for cd in ("bfloat16", "float32"):
            model = build_model(dataclasses.replace(cfg, compute_dtype=cd))
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            for route, fn in (("k6", mha), ("plain", attention_ref)):
                flash_ops.mha = fn
                try:
                    logits[f"{cd}/{route}"] = model.prefill(
                        params, toks.to(dev))[0].double()
                finally:
                    flash_ops.mha = mha
            del params
            torch.cuda.empty_cache()
        out = {"wave": name, "shape": list(toks.shape), "card": card}
        for a, b in (("bfloat16/k6", "bfloat16/plain"),
                     ("float32/k6", "float32/plain"),
                     ("bfloat16/k6", "float32/plain"),
                     ("bfloat16/plain", "float32/plain")):
            x, y = logits[a], logits[b]
            d = (x - y).abs()
            out[f"{a} vs {b}"] = {
                "max": float(d.max()), "mean": float(d.mean()),
                "p99.9": float(torch.quantile(d.flatten()[::7].float(),
                                              0.999)),
                "outside_tol": float((d > TOL + TOL * y.abs()).double()
                                     .mean()),
                "greedy_agree": float((x.argmax(-1) == y.argmax(-1))
                                      .double().mean())}
        out["logits_abs_max"] = float(logits["float32/plain"].abs().max())
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
