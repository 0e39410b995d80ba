"""Case tables and seeded inputs for the ring kernels K1-K4, DD layer
expansion K5, flash attention K6 and the SSD scan K7, shared by the CPU
tests (plain versions against the JAX package's Pallas kernels) and
``chip_smoke.py`` (CUDA kernels against their plain versions on the card).

``STEAL_CASES``, ``TRANSFER_CASES`` and ``FLASH_CASES`` are the JAX
package's own tables (``tests/test_kernels.py``); the scatter and slice
tables cover the same ground for K2 and K3: wrapped rings, empty and full
moves, int32 and bfloat16 payloads.  ``STEAL_BYTE_CASES``,
``TRANSFER_BYTE_CASES`` and the payload tree ``TREE_LEAVES`` /
``TREE_CASE`` cover the byte path of K1 and K4 (``ring_copy.cuh``).
``FLASH_EXTRA_CASES`` adds what the serving path and the card need beyond
them: causal ``S > T`` (rows that see no key), windows, head dims 112 and
256 and GQA in bfloat16, and bfloat16 rows for every route of the
tensor-core kernel (head dim 128 without the causal mask, ragged ``S = T =
100`` with a softcap, GQA groups of 8).
``SLICE_TREE_CASE`` moves ``TREE_LEAVES`` through K3, and
``SCATTER_BYTE_CASES`` and ``SCATTER_TREE_CASE`` cover K2's byte path and
tree.
``EXPAND_CASES`` and ``SSD_CASES`` are the JAX package's tables for K5
and K7; ``EXPLORE_CASES`` cover K5's redesign, the fused DD explore;
``SSD_EXTRA_CASES`` adds ragged lengths (``S % Q != 0``, ``S < Q``),
bfloat16, the SSM archs' widths and the other shapes of K7's
tensor-core route; ``SSD_SLICE`` and ``SSD_HYBRID`` are the serving path's
two K7 shapes.  Payload dtypes are names, so the tables import nothing but
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["STEAL_CASES", "TRANSFER_CASES", "SCATTER_CASES", "SLICE_CASES",
           "STEAL_BYTE_CASES", "TRANSFER_BYTE_CASES", "TREE_LEAVES",
           "TREE_CASE", "tree_payload",
           "FLASH_CASES", "FLASH_EXTRA_CASES", "FLASH_SLICE", "FLASH_ZAMBA",
           "FLASH_TOL",
           "SLICE_TREE_CASE", "SCATTER_BYTE_CASES", "SCATTER_TREE_CASE",
           "EXPAND_CASES", "EXPAND_SOLVER", "expand_inputs",
           "EXPLORE_CASES", "explore_inputs",
           "SSD_CASES", "SSD_EXTRA_CASES", "SSD_SLICE", "SSD_HYBRID",
           "SSD_TOL",
           "ssd_inputs", "payload", "to_tensor"]

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

# K1 and K4 on the byte path, several lanes a row: 4-byte rows at every
# residue mod 4 rows (0, 4, 8 and 12 bytes mod 16), rows of 3 and 5 int32
# words and 6-byte bfloat16 rows, output blocks whose lanes start off a
# 16-byte boundary (33 rows of 12 bytes), live counts that end mid-vector,
# segments that end exactly at cap, n = 0 and n = cap, and for K1
# max_steal > cap with n > cap (the segment laps the ring) and a negative
# lo.  (cap, D, max_steal, lo per lane, n per lane, dtype)
STEAL_BYTE_CASES = [
    (64, 1, 32, (0, 1, 2, 3), (13, 32, 7, 0), "int32"),
    (66, 3, 33, (61, 62, 63, 65), (5, 33, 3, 1), "int32"),    # 65 + 1 = cap
    (64, 5, 64, (1, 30, 59, 34), (63, 34, 5, 64), "int32"),   # ends at cap
    (64, 3, 64, (5, 6, 7, 8), (64, 0, 61, 1), "bfloat16"),    # n = cap
    (16, 1, 48, (3, 14, 0, 9), (48, 33, 16, 17), "float32"),  # laps the ring
    (16, 3, 48, (15, -5, 7, 1), (40, 48, 16, 9), "bfloat16"),
]

# The same ground for K4, plus n = cap (max_steal = cap), source rows
# past the stack (src_row >= W: every row reads the stack's last one) and
# negative source rows (src_row in [-W, 0): window src_row + W, as Python
# indexing counts from the end).
# (cap, D, W, max_steal, head per lane, src_row per lane, n per lane, dtype)
TRANSFER_BYTE_CASES = [
    (64, 1, 4, 32, (0, 1, 2, 3), (3, 2, 1, 0), (13, 32, 7, 0), "int32"),
    (64, 3, 4, 32, (61, 62, 63, 60), (0, 1, 2, 3), (5, 32, 3, 4), "int32"),
    (64, 5, 4, 16, (1, 48, 59, 34), (1, 0, 3, 2), (16, 16, 5, 7), "int32"),
    (64, 3, 3, 32, (5, 6, 7, 8), (2, 1, 0, 2), (31, 0, 32, 1), "bfloat16"),
    (32, 3, 2, 32, (5, 6, 7, 31), (1, 0, 1, 0), (32, 0, 17, 32),
     "bfloat16"),                                             # n = cap
    (32, 5, 2, 16, (3, 30, 9, 0), (2, 1, 5, 0), (16, 9, 4, 16),
     "float32"),                                              # past the stack
    (64, 3, 3, 16, (60, 2, 17, 40), (-1, -3, -7, -2), (16, 9, 0, 5),
     "int32"),              # negative rows; below -W where nothing is read
]

# A payload tree of mixed dtypes and widths, (trailing shape, dtype) per
# leaf, moved by one launch of K1 and one of K4.
TREE_LEAVES = {"id": ((), "int32"), "vec": ((3,), "bfloat16"),
               "w": ((5,), "float32")}
# (cap, max_steal, W, lo / head per lane, n per lane, src_row per lane)
TREE_CASE = (48, 24, 3, (47, 5, 18, 30, 1), (24, 0, 13, 18, 7),
             (2, 0, 1, 2, 0))

# K3 on the same tree: (cap, max_n, lo per lane, size per lane, n per
# lane), n <= min(size, max_n); the newest rows wrap the ring on lanes 0
# and 3, lane 1 pops nothing.
SLICE_TREE_CASE = (48, 24, (40, 5, 18, 40, 1), (30, 0, 13, 20, 24),
                   (24, 0, 13, 20, 7))

# K2 on the byte path, several lanes a row: 4-byte rows at every residue
# mod 16 bytes, 12-, 20- and 6-byte rows, batch blocks whose lanes start
# off a 16-byte boundary (33 rows of 12 bytes), pushes that end exactly at
# cap, n = 0 and n = cap, max_push > cap with n > cap (only cap rows are
# written), negative starts (Python's `%`: counted from the ring's end),
# a start past cap and a negative n (nothing written).
# (cap, D, max_push, start per lane, n per lane, dtype)
SCATTER_BYTE_CASES = [
    (64, 1, 32, (0, 1, 2, 3), (13, 32, 7, 0), "int32"),
    (66, 3, 33, (61, 62, 63, 65), (5, 33, 3, 1), "int32"),    # 65 + 1 = cap
    (64, 5, 64, (1, 30, 59, 34), (63, 34, 5, 64), "int32"),   # ends at cap
    (64, 3, 64, (5, 6, 7, 8), (64, 0, 61, 1), "bfloat16"),    # n = cap
    (16, 1, 48, (3, 14, 0, 9), (48, 33, 16, 17), "float32"),  # n > cap
    (16, 3, 48, (15, -5, 7, 1), (40, 48, 16, 9), "bfloat16"),
    (32, 5, 16, (-1, 40, 31, -33), (16, 9, -2, 5), "float32"),
]

# K2 on TREE_LEAVES: (cap, max_push, start per lane, n per lane).  Lane 0
# wraps the ring, lane 1 pushes nothing, lane 2 has a negative start and n
# past max_push (24 rows written, wrapping), lane 4 a start past cap, lane
# 5 a negative n.
SCATTER_TREE_CASE = (48, 24, (40, 5, -7, 30, 100, 13), (24, 0, 30, 13, 7, -2))

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
    (1, 128, 128, 4, 4, 112, True, 32, 30.0, "float32"),     # hd 112
    (2, 256, 256, 4, 4, 112, True, None, None, "bfloat16"),   # zamba2's hd
    (2, 256, 256, 4, 2, 128, False, None, None, "bfloat16"),  # hd 128, full
    (2, 100, 100, 4, 2, 64, True, None, 30.0, "bfloat16"),    # ragged, cap
    (1, 256, 256, 16, 2, 64, True, None, None, "bfloat16"),   # GQA group 8
] + [
    # unmasked, 16 heads of 64 (MHA): the enc-dec family's cross-attention
    # (S != T) and bidirectional encoder, whole and ragged KV tails
    (B, S, T, 16, 16, 64, False, None, None, dtype)
    for B, S, T in ((2, 128, 256),      # S < T
                    (2, 256, 128),      # S > T
                    (1, 100, 100),      # ragged, S = T
                    (1, 64, 100),       # ragged T, S < T
                    (1, 100, 60))       # ragged, S > T
    for dtype in ("bfloat16", "float32")
]

# Unmasked rows whose KV length is ragged past a whole tile (the JAX
# kernel takes only whole blocks, so the CPU tests hold these against the
# JAX package's reference): seamless-m4t-medium's cross-attention at 1,000
# encoder frames, and its encoder over them.
FLASH_RAGGED_CASES = [
    (1, S, 1000, 16, 16, 64, False, None, None, dtype)
    for S in (256, 1000) for dtype in ("bfloat16", "float32")
]

# Prefill attention of the serving slice: a wave of 4 prompts of 1,024
# tokens through one layer of llama3.2-1b (32 heads over 8 KV heads of 64).
FLASH_SLICE = (4, 1024, 1024, 32, 8, 64, True, None, None, "bfloat16")
# The same wave through zamba2-7b's shared attention (32 heads of 112, MHA).
FLASH_ZAMBA = (4, 1024, 1024, 32, 32, 112, True, None, None, "bfloat16")
# seamless-m4t-medium's cross-attention in a prefill of 4 utterances: 256
# target tokens against 1,000 encoder frames, 16 heads of 64, unmasked.
FLASH_CROSS = (4, 256, 1000, 16, 16, 64, False, None, None, "bfloat16")

# The JAX package's tolerances for the flash kernel (tests/test_kernels.py).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# K5: (N, (w, p)) — the JAX package's table; states in [-1, 100), values
# in [0, 50).
EXPAND_CASES = [(n, wp) for n in (256, 512, 1024)
                for wp in ((3, 8), (50, 1), (0, 0))]
# The solver's pools (chip_smoke.py phase 3): 64 workers x 8 popped
# subproblems, explore width 16.
EXPAND_SOLVER = (64 * 8, 16)


# The fused DD explore: (what, subproblems B, pool width, n_vars, and the
# closed ranges of the weights, profits, root states, root layers and root
# values, share of invalid rows).  "solver" is phase 3's batch (64 lanes x
# 8 pops, width 16, the 30-item knapsack's weights, profits and
# capacities); "exact" roots sit three layers from the end, so every exact
# DD completes (2^3 <= 16 nodes); "overflow" roots sit at layer 0 with
# room for every item, so every exact DD overflows; "ties" draws tiny
# weights (0 among them: both arcs reach one state), profits and states, so
# many children share a state or a value; "edges" adds negative weights
# and profits, root layers outside [0, n_vars) and root values at -2^30
# and below; then two more widths, the largest explore.cu takes among them.
# A root state of -1 is a dead root.
EXPLORE_CASES = [
    ("solver", 512, 16, 30, (1, 50), (1, 100), (0, 400), (0, 29), (0, 999),
     0.25),
    ("exact", 64, 16, 12, (1, 50), (1, 100), (0, 600), (9, 11), (0, 999),
     0.0),
    ("overflow", 64, 8, 20, (1, 50), (1, 100), (600, 1000), (0, 0),
     (0, 999), 0.0),
    ("ties", 256, 8, 16, (0, 3), (0, 3), (-1, 12), (0, 15), (0, 9), 0.2),
    ("edges", 96, 4, 10, (-2, 3), (-3, 3), (-3, 9), (-2, 10),
     (-2 ** 30 - 3, -2 ** 30 + 3), 0.1),
    ("width 32", 128, 32, 24, (1, 20), (1, 40), (0, 200), (0, 23), (0, 999),
     0.1),
    ("width 5", 128, 5, 16, (1, 10), (1, 20), (-1, 60), (0, 15), (0, 999),
     0.1),
]


def explore_inputs(rng: np.random.Generator, case) -> dict:
    """Seeded numpy inputs of an ``EXPLORE_CASES`` entry: int32 ``layer``,
    ``state``, ``value`` and bool ``valid`` of shape ``(B,)``, int32
    ``weights`` and ``profits`` of shape ``(n_vars,)``."""
    _, b, _, n_vars, w, p, s, layer, v, invalid = case

    def draw(lo_hi, n):
        return rng.integers(lo_hi[0], lo_hi[1] + 1, n).astype(np.int32)

    return {"layer": draw(layer, b), "state": draw(s, b), "value": draw(v, b),
            "valid": rng.random(b) >= invalid, "weights": draw(w, n_vars),
            "profits": draw(p, n_vars)}


def expand_inputs(rng: np.random.Generator, shape, device):
    """Seeded int32 (states, values) of a K5 case."""
    s = rng.integers(-1, 100, shape, dtype=np.int32)
    v = rng.integers(0, 50, shape, dtype=np.int32)
    return (torch.from_numpy(s).to(device), torch.from_numpy(v).to(device))


# K7: (B, S, nh, hd, ns, Q, dtype) — the JAX package's table first.
SSD_CASES = [
    (2, 64, 4, 16, 32, 16, "float32"),
    (1, 128, 2, 32, 16, 32, "float32"),
    (2, 256, 8, 64, 128, 128, "float32"),
    (1, 64, 1, 8, 8, 64, "float32"),        # single chunk (S == Q)
]
SSD_EXTRA_CASES = [
    (2, 100, 3, 16, 16, 32, "float32"),     # ragged last chunk
    (1, 10, 2, 16, 16, 16, "float32"),      # S < Q
    (2, 1, 2, 8, 8, 16, "float32"),         # one token
    (2, 300, 4, 64, 64, 256, "float32"),    # zamba2's widths, ragged
    (1, 700, 2, 64, 128, 256, "bfloat16"),  # mamba2's widths, ragged
    (2, 100, 4, 16, 16, 16, "bfloat16"),    # the reduced configs' widths
    # the tensor-core route's other shapes: chunk 192, ragged, a group of
    # 8 heads and one more; one token at chunk 64; 17 heads, two chunks,
    # the second ragged; mamba2's 80 heads in one ragged chunk
    (2, 200, 9, 64, 128, 192, "bfloat16"),
    (1, 1, 3, 64, 64, 64, "bfloat16"),
    (3, 333, 17, 64, 64, 256, "bfloat16"),
    (1, 130, 80, 64, 128, 256, "bfloat16"),
]
# The prefill scan of the serving slice: a wave of 4 prompts of 1,024
# tokens through one layer of mamba2-2.7b (80 heads of 64, state 128,
# chunk 256).
SSD_SLICE = (4, 1024, 80, 64, 128, 256, "bfloat16")
# The same wave through one Mamba2 block of zamba2-7b (112 heads of 64,
# state 64, chunk 256).
SSD_HYBRID = (4, 1024, 112, 64, 64, 256, "bfloat16")

# The JAX package's tolerance for the SSD kernel (tests/test_kernels.py)
# in float32, as (atol, rtol); in bfloat16 the output is rounded to 8 bits
# of mantissa, so two correct float32 sums may land one bf16 step apart.
SSD_TOL = {"float32": (5e-5, 5e-4), "bfloat16": (2e-2, 2e-2)}


def ssd_inputs(rng: np.random.Generator, case, device):
    """Seeded (x, dt, A, Bm, Cm, D) of a K7 case, drawn as the JAX package's
    test draws them: x ~ N(0, 0.5^2), dt = softplus(N(0, 1)), A =
    -exp(0.3 N(0, 1)), Bm, Cm ~ N(0, 0.3^2), D = 1; x, Bm and Cm in the
    case's dtype, the rest float32."""
    B, S, nh, hd, ns, _, dtype = case
    f32 = np.float32
    x = rng.standard_normal((B, S, nh, hd)).astype(f32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(f32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(f32)
    Bm = rng.standard_normal((B, S, ns)).astype(f32) * 0.3
    Cm = rng.standard_normal((B, S, ns)).astype(f32) * 0.3
    D = np.ones(nh, f32)
    cd = getattr(torch, dtype)
    return tuple(torch.from_numpy(a).to(device=device, dtype=t) for a, t in (
        (x, cd), (dt, torch.float32), (A, torch.float32), (Bm, cd), (Cm, cd),
        (D, torch.float32)))


def payload(rng: np.random.Generator, shape, dtype: str) -> np.ndarray:
    """Seeded payload values: int32 in [0, 1000), float32 normals, or —
    for bfloat16 — the uint16 bits of bfloat16 normals."""
    if dtype == "int32":
        return rng.integers(0, 1000, shape, dtype=np.int32)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return (x.view(np.uint32) >> 16).astype(np.uint16)
    return x


def tree_payload(rng: np.random.Generator, lead, leaves=None) -> dict:
    """Seeded :func:`payload` arrays of a tree: ``lead + trailing shape``
    per leaf of ``leaves`` (default :data:`TREE_LEAVES`)."""
    leaves = TREE_LEAVES if leaves is None else leaves
    return {k: payload(rng, tuple(lead) + shape, dtype)
            for k, (shape, dtype) in leaves.items()}


def to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The tensor of a :func:`payload` array (bfloat16 from its bits)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)
