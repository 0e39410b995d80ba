#!/usr/bin/env python3
"""How close the SSD scan comes to exact arithmetic at the SSM slice's
shape: K7 (the CUDA kernel) and its plain version (``ssd_chunked``), both
in float32, against the token-by-token recurrence in float64,

    state_t = state_{t-1} exp(dt_t a) + dt_t x_t B_t^T,
    y_t     = state_t C_t + D x_t,

which is what the chunked scan computes, summed another way.  Inputs are
``chip_smoke.py`` phase 1's for the slice's shape in float32 (B 4, S
1,024, 80 heads of 64, state 128, chunk 256; seed 0).  Prints the card's
name and power limit and one JSON line: for y and the final state, the
max abs difference of each pair and the share of values outside the JAX
package's tolerance (atol 5e-5 + rtol 5e-4 x |reference|).

    python3 scripts/ssd_precision.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 5e-5, 5e-4


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


def compare(got, ref) -> dict:
    d = (got.double() - ref.double()).abs()
    outside = d > ATOL + RTOL * ref.double().abs()
    return {"max_abs": float(d.max()),
            "share_outside_tol": float(outside.double().mean())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_precision: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    case = C.SSD_SLICE[:-1] + ("float32",)
    args = C.ssd_inputs(np.random.default_rng(0), case, "cuda")
    Q = case[5]
    kernel, plain, exact = (ssd(*args, chunk=Q), ssd_chunked(*args, Q),
                            recurrence(*args))
    out = {"shape": list(case)}
    for i, what in enumerate(("y", "final_state")):
        out[what] = {"kernel_vs_exact": compare(kernel[i], exact[i]),
                     "plain_vs_exact": compare(plain[i], exact[i]),
                     "kernel_vs_plain": compare(kernel[i], plain[i])}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
