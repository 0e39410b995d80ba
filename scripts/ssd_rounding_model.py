#!/usr/bin/env python3
"""A float32 model, on the CPU, of the bf16 splits in K7's tensor-core
kernel (``kernels/ssd_scan/ssd_scan_wgmma.cu``): how far its y would land
from the plain version's (``ref.ssd_chunked``) if each of the three
operands that are not inputs — G o L, the incoming state S_in and x w —
went into the products as a sum of k bf16 parts.

The model follows the kernel's order (``ref.ssd_chunk_parallel``: chunk
states, state passing, chunk output) with the operands so rounded and
every product and sum in float32; it models the arithmetic, not the card
(the tensor cores' summation order and rounding are not in it).  Inputs
are ``scripts/ssd_precision.py``'s: ``cases.ssd_inputs`` with seed 0 at
the chosen shape, one batch row at a time.  Prints one JSON line per
batch row and split (k for G o L, S_in, x w): y's max abs difference from
the plain version, the count of outputs 2e-2 or more away, and the final
state's max abs difference; beside them the plain version's largest |y|
and its count of outputs with |y| >= 4, where one bf16 step is 0.03125.
About a minute per batch row and split at the serving shapes.

    python3 scripts/ssd_rounding_model.py --shape slice --splits 1,1,2 3,2,2
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import cases as C  # noqa: E402
from repro_torch.kernels.ssd_scan import ref  # noqa: E402

SHAPES = {"slice": C.SSD_SLICE, "hybrid": C.SSD_HYBRID}


def bf16_parts(v: torch.Tensor, k: int) -> torch.Tensor:
    """``v`` as the float32 sum of ``k`` bf16 parts, each the bf16
    rounding of what the parts before it leave."""
    total, rest = torch.zeros_like(v), v
    for _ in range(k):
        part = rest.to(torch.bfloat16).float()
        total, rest = total + part, rest - part
    return total


def modelled_scan(x, dt, A, Bm, Cm, D, chunk: int, k_gl: int, k_s: int,
                  k_xw: int):
    """(y in x's dtype, final state) with G o L, S_in and x w in ``k_gl``,
    ``k_s`` and ``k_xw`` bf16 parts."""
    Bsz, S, nh, hd = x.shape
    xq, dtq, Bq, Cq = ref._chunks(x, dt, Bm, Cm, chunk)
    cs = torch.cumsum((dtq * A.float()).double(), 2)
    w = dtq * torch.exp((cs[:, :, -1:] - cs).float())
    local = torch.einsum("bcjhd,bcjn->bchdn",
                         bf16_parts(w[..., None] * xq, k_xw), Bq)
    s_in, final = ref.pass_states(local, cs)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    G = torch.einsum("bcin,bcjn->bcij", Cq, Bq)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    L = torch.where(causal[:, :, None], torch.exp(diff.float()), 0.0) \
        * dtq[:, :, None]
    y = torch.einsum("bcijh,bcjhd->bcihd", bf16_parts(G[..., None] * L, k_gl),
                     xq)
    y = y + torch.exp(cs.float())[..., None] * torch.einsum(
        "bcin,bchdn->bcihd", Cq, bf16_parts(s_in, k_s))
    y = y + xq * D.float()[:, None]
    return y.reshape(Bsz, -1, nh, hd)[:, :S].to(x.dtype), final


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=sorted(SHAPES), default="slice")
    ap.add_argument("--batches", type=int, default=1)
    ap.add_argument("--splits", nargs="+", default=["1,1,2", "2,1,2",
                                                     "3,2,2"])
    args = ap.parse_args()
    case = SHAPES[args.shape]
    splits = [tuple(int(k) for k in s.split(",")) for s in args.splits]
    inputs = C.ssd_inputs(np.random.default_rng(0), case, "cpu")
    for b in range(min(args.batches, case[0])):
        row = tuple(t[b:b + 1] if t.dim() > 1 else t for t in inputs)
        y, state = ref.ssd_chunked(*row, case[5])
        size = y.float().abs()
        for k in splits:
            y_m, state_m = modelled_scan(*row, case[5], *k)
            d = (y.float() - y_m.float()).abs()
            print(json.dumps({
                "shape": list(case), "batch_row": b,
                "parts_gl_s_xw": list(k), "y_max_abs": float(d.max()),
                "y_at_least_2e-2": int((d >= 2e-2).sum()),
                "state_max_abs": float((state - state_m).abs().max()),
                "plain_y_max": float(size.max()),
                "plain_y_at_least_4": int((size >= 4).sum())}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
