"""Case tables and seeded inputs for the ring kernels K1-K4 and flash
attention K6, shared by the CPU tests (plain versions against the JAX
package's Pallas kernels) and ``chip_smoke.py`` (CUDA kernels against
their plain versions on the card).

``STEAL_CASES``, ``TRANSFER_CASES`` and ``FLASH_CASES`` are the JAX
package's own tables (``tests/test_kernels.py``); the scatter and slice
tables cover the same ground for K2 and K3: wrapped rings, empty and full
moves, int32 and bfloat16 payloads.  ``FLASH_EXTRA_CASES`` adds what the
serving path and the card need beyond them: causal ``S > T`` (rows that
see no key), windows, head dim 256 and GQA in bfloat16.  Payload dtypes
are names, so the tables import nothing but numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["STEAL_CASES", "TRANSFER_CASES", "SCATTER_CASES", "SLICE_CASES",
           "FLASH_CASES", "FLASH_EXTRA_CASES", "FLASH_SLICE", "FLASH_TOL",
           "payload", "to_tensor"]

# (cap, D, max_steal, lo, n, dtype)
STEAL_CASES = [
    (512, 8, 256, 0, 100, "float32"),
    (512, 8, 256, 500, 256, "float32"),     # wraps
    (1024, 16, 512, 777, 333, "float32"),
    (256, 4, 256, 255, 256, "int32"),       # full wrap, int payload
    (256, 4, 128, 13, 0, "float32"),        # empty steal
    (256, 128, 256, 100, 200, "bfloat16"),
]

# (cap, D, n_lanes, max_steal, head, src_row, n, dtype)
TRANSFER_CASES = [
    (512, 8, 4, 256, 0, 0, 100, "float32"),
    (512, 8, 4, 256, 500, 3, 256, "float32"),   # splice wraps the ring
    (1024, 16, 8, 128, 777, 5, 33, "float32"),
    (256, 4, 4, 64, 255, 2, 64, "int32"),       # int payload, wrap
    (256, 4, 4, 64, 13, 1, 0, "float32"),       # empty transfer
    (256, 128, 2, 128, 100, 1, 77, "bfloat16"),
]

# (cap, D, max_push, start, n, dtype)
SCATTER_CASES = [
    (512, 8, 128, 0, 100, "float32"),
    (512, 8, 128, 450, 128, "float32"),     # splice wraps the ring
    (256, 4, 128, 255, 128, "int32"),       # int payload, wrap
    (256, 4, 128, 13, 0, "float32"),        # empty push
    (512, 8, 256, 300, 256, "float32"),     # full batch, wraps
    (256, 128, 128, 100, 77, "bfloat16"),
    (256, 1, 128, 200, 99, "bfloat16"),     # 2-byte rows
]

# (cap, D, max_n, lo, size, n, dtype)
SLICE_CASES = [
    (512, 8, 128, 0, 300, 100, "float32"),
    (512, 8, 128, 450, 100, 100, "float32"),  # block wraps the ring
    (256, 4, 128, 200, 130, 128, "int32"),    # int payload, wrap
    (256, 4, 128, 13, 50, 0, "float32"),      # empty pop
    (256, 8, 256, 37, 256, 256, "float32"),   # pop the full ring
    (256, 128, 128, 100, 200, 77, "bfloat16"),
    (256, 1, 8, 250, 10, 8, "bfloat16"),      # 2-byte rows, wrap
]

# (B, S, T, H, K, hd, causal, window, softcap, dtype)
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None, "float32"),
    (1, 256, 256, 4, 4, 64, True, 128, None, "float32"),
    (2, 128, 256, 8, 2, 32, True, None, 50.0, "float32"),
    (1, 128, 128, 2, 1, 128, False, None, None, "float32"),
    (1, 128, 128, 4, 4, 64, True, None, None, "bfloat16"),
    (2, 128, 256, 4, 2, 32, True, 64, 30.0, "float32"),
]

FLASH_EXTRA_CASES = [
    (2, 256, 128, 4, 2, 64, True, None, None, "float32"),     # S > T
    (1, 256, 128, 4, 1, 32, True, 16, 50.0, "bfloat16"),      # S > T, window
    (1, 100, 100, 2, 1, 256, True, 16, 50.0, "float32"),      # hd 256, ragged
    (2, 256, 256, 8, 2, 256, True, None, None, "bfloat16"),   # hd 256, GQA
]

# Prefill attention of the serving slice: a wave of 4 prompts of 1,024
# tokens through one layer of llama3.2-1b (32 heads over 8 KV heads of 64).
FLASH_SLICE = (4, 1024, 1024, 32, 8, 64, True, None, None, "bfloat16")

# The JAX package's tolerances for the flash kernel (tests/test_kernels.py).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def payload(rng: np.random.Generator, shape, dtype: str) -> np.ndarray:
    """Seeded payload values: int32 in [0, 1000), float32 normals, or —
    for bfloat16 — the uint16 bits of bfloat16 normals."""
    if dtype == "int32":
        return rng.integers(0, 1000, shape, dtype=np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return (x.view(np.uint32) >> 16).astype(np.uint16)
    return x


def to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The tensor of a :func:`payload` array (bfloat16 from its bits)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)
