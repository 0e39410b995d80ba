#!/usr/bin/env python3
"""How close the SSD scan comes to exact arithmetic at the serving
shapes, on both of K7's routes: in float32 the SIMT kernel, in bfloat16 the
tensor-core kernel and, beside it, the SIMT kernel (its earlier design) —
each with its plain version (``ssd_chunked``) on the same inputs —
against the token-by-token recurrence in float64 on those inputs,

    state_t = state_{t-1} exp(dt_t a) + dt_t x_t B_t^T,
    y_t     = state_t C_t + D x_t,

which is what the chunked scan computes, summed another way.  Inputs are
``cases.ssd_inputs`` with seed 0 at the SSM slice's shape (B 4, S 1,024,
80 heads of 64, state 128, chunk 256) in float32 and bfloat16 and at
zamba2-7b's (112 heads, state 64) in bfloat16.  Prints
the card's name and power limit and one JSON line per case: for y and the
final state, the max abs difference of each pair, the share of values
outside the dtype's tolerance (``cases.SSD_TOL``: atol 5e-5 + rtol 5e-4 x
|reference| in float32, 2e-2 + 2e-2 x |reference| in bfloat16), and the
counts of values farther apart than its atol alone and of values that
differ at all.

    python3 scripts/ssd_precision.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def recurrence(x, dt, A, Bm, Cm, D):
    """The scan token by token in float64: (y, final state)."""
    import torch
    x, dt, A, Bm, Cm, D = (t.double() for t in (x, dt, A, Bm, Cm, D))
    B, S, nh, hd = x.shape
    state = x.new_zeros((B, nh, hd, Bm.shape[-1]))
    y = torch.empty_like(x)
    for t in range(S):
        state = (state * torch.exp(dt[:, t] * A)[:, :, None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * Bm[:, t, None, None, :])
        y[:, t] = torch.einsum("bhdn,bn->bhd", state, Cm[:, t]) \
            + D[:, None] * x[:, t]
    return y, state


def compare(got, ref, tol) -> dict:
    atol, rtol = tol
    d = (got.double() - ref.double()).abs()
    outside = d > atol + rtol * ref.double().abs()
    return {"max_abs": float(d.max()),
            "share_outside_tol": float(outside.double().mean()),
            "count_over_atol": int((d > atol).sum()),
            "count_differing": int((d > 0).sum())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.ssd_scan.ops import route, ssd, ssd_simt
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for case in (C.SSD_SLICE[:-1] + ("float32",), C.SSD_SLICE,
                 C.SSD_HYBRID):
        dtype = case[-1]
        args = C.ssd_inputs(np.random.default_rng(0), case, "cuda")
        _, _, _, hd, ns, Q, _ = case
        tol = C.SSD_TOL[dtype]
        runs = {"kernel": ssd(*args, chunk=Q),
                "plain": ssd_chunked(*args, Q)}
        if dtype == "bfloat16":
            runs["simt"] = ssd_simt(*args, chunk=Q)
        exact = recurrence(*args)
        out = {"shape": list(case),
               "kernel_route": route(args[0].dtype, hd, ns, Q)}
        for i, what in enumerate(("y", "final_state")):
            out[what] = {f"{name}_vs_exact": compare(got[i], exact[i], tol)
                         for name, got in runs.items()}
            out[what]["kernel_vs_plain"] = compare(runs["kernel"][i],
                                                   runs["plain"][i], tol)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
