#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port only (``src/repro_torch``; it imports neither JAX nor
the JAX package) and fails — non-zero exit, no result line — on the first
check that does not hold:

1. Build and kernel parity.  Builds the CUDA kernels from the checkout's
   sources (``repro_torch.kernels._lib``).  Holds each ring kernel (K1-K4)
   against its plain PyTorch version bit for bit — on the kernel case
   tables, on K1, K2 and K4's byte path (rows of 4, 12, 20 and 6 bytes at
   every offset mod 16, bases off a 16-byte boundary, segments that lap
   the ring, K2's negative starts and n past max_push) and payload trees
   (three mixed-dtype leaves in one launch, twelve in two, for K1-K4), and
   at the solver's geometry (64 lanes, 16,384-row rings, max_steal 8,192,
   128-row pushes, 8-row pops) in float32, int32 and bfloat16 — DD layer
   expansion (K5) bit for bit on
   its case table and at the solver's pools (512 x 16 nodes), and K5's
   redesign, the fused DD explore (restricted and relaxed DDs and the
   exact frontier of a batch of subproblems in one launch), bit for bit
   against its plain version on ``cases.EXPLORE_CASES`` (the solver's
   batch of 512 subproblems at width 16 over 30 layers, exact DDs that
   complete and that overflow, ties, edge values, widths 4, 5, 8 and
   32).  Holds flash attention
   (K6: bfloat16 through the tensor-core kernel, float32 through the SIMT
   kernel) within the JAX package's tolerances (2e-5 float32, 2e-2
   bfloat16) on its case tables (head dims 32 to 256, 112 among them), at
   the serving slice's prefill shape (B 4, S = T 1,024, 32 heads over 8 KV
   heads of 64, bfloat16, causal) and at zamba2-7b's (32 heads of 112,
   MHA), and the SSD scan (K7: bfloat16 at head dim 64 and state widths
   64 and 128 through the tensor-core kernel, float32 and the other
   bfloat16 shapes through the SIMT kernel) within atol 5e-5 / rtol 5e-4
   in float32 (2e-2 in bfloat16) on its case tables (ragged lengths among
   them) and their bfloat16 copies, at the SSM slice's prefill shape (B 4,
   S 1,024, 80 heads of 64, state 128, chunk 256) in bfloat16 and float32
   and at zamba2-7b's (112 heads of 64, state 64).  Times kernel, plain
   version and a library yardstick (``index_select`` / ``index_copy_``;
   SDPA for K6; none for K5 and K7) with CUDA events; K6 and K7 at both
   of their shapes, beside the SIMT kernel's bfloat16 time (their earlier
   design); K1-K4 also as the solver calls them, on its three-leaf
   payload (``solver_payload``); the fused explore at the solver's batch
   beside K5's time per layer (its earlier design).  Then the paper's Fig.
   6 on the card (``{"phase": "push_latency"}``): K2's time per push of 1
   to 8,192 rows on every one of the 64 int32 rings of 16,384 rows, beside
   ``index_copy_`` and the byte bound.
2. The queue at the paper's backlog.  64 lanes of 16,384 rows, half of
   them holding 10,000 seeded unique items; 8 rebalancing supersteps on the
   kernel backend under the compact and the dense exchange and on the
   reference backend.  Rings, cursors and round records must agree across
   the three runs, and every item must survive exactly once.
3. The DD solver at full size.  ``parallel_solve`` on a 30-item knapsack
   with 64 workers; it must reproduce the JAX package's integer results,
   and each of the four ring kernels and the fused explore must have
   launched during that run: the fused explore and K3 once per worker
   body, K2 once per push (the runtime's seed push and one per worker
   body), K3 and K2 one launch per payload tree, K5 per layer not at
   all.
4. Serving at full width.  The wave engine (two replicas, one at a
   quarter speed, behind the bulk-steal admission master) serves 24
   requests of 128-1,024 prompt tokens and 16 new tokens each with
   llama3.2-1b at its published widths and random weights from seed 0.
   Every request must be served in full, the master must have stolen,
   K6 must have launched once per layer and prefill wave, every launch
   on its tensor-core route (bfloat16 compute), and the first
   wave's prefill logits must agree with the same prefill through K6's
   plain version (swapped in for that one call): within 1e-4 in float32
   compute, and in the run's bfloat16 compute as close to the float32
   logits as the plain version's (mean distance at most 1.1x).
5. SSM serving at full size.  The same setup with mamba2-2.7b at its
   published widths and depth (64 layers, 2.7 B parameters): K7 must have
   launched once per layer and prefill wave, every launch on its
   tensor-core route, and the first wave passes the same two checks
   against K7's plain version.
6. The hybrid, one wave.  zamba2-7b at its published widths and depth (81
   layers, 6.6 B parameters) runs one wave of 4 prompts: K6 must have
   launched once per shared-block application (13), all on its
   tensor-core route, and K7 once per Mamba2 block (81), all on its
   tensor-core route; every request must get its tokens, and the first
   wave passes the two checks against both plain versions at once.

7. The checkers (``{"phase": "checkers"}``, after phase 3).  (a) Phase 2's
   backlog on the relaxed backend and on the kernel backend under the
   runtime sanitizer (``make_ops("cuda", check=True)``): rings and cursors
   bit-equal to the plain kernel backend's under both exchanges, the
   live-item multiset conserved, no violation, K1 and K4 launched under
   the relaxed backend; ms per superstep of each.  (b) The exhaustive
   linearizability checker over the reference, kernel and relaxed
   backends on rings of (4, 2) and (8, 4) on the card: 330 histories per
   fenced backend and 636 for the split relaxed steal per geometry, none
   violating, and both seeded reconcile mutations caught.  (c)
   ``PagedQueue`` past its ring: 131,072 distinct ids (8x one 16,384-row
   int32 ring, pages of 8,192) pushed in batches of 1,024, stolen and
   popped through spills and refills, every id back exactly once under
   the sanitizer's spill/refill audit; ms per push with and without it.

3b. The sequential solver (``{"phase": "solver_sequential"}``, after phase
   3): ``bnb.solve`` on phase 3's instance at its defaults (width 32,
   batch 16) must return the JAX package's optimum and counts, with one
   launch of the fused explore per step; ms per step.
8. Resilience at the backlog's size (``{"phase": "resilience"}``, after
   phase 7).  The Fig. 9 DAG (262,144 nodes, fan-out 4, pops of 128, one
   root on lane 0) on phase 2's 64 int32 lanes of 16,384 rows, drained in
   blocks of 16 rounds: (a) flat, lane 3 killed at round 6, lane 17
   delayed for rounds 4-7, round 8's exchange dropped; (b) the same in 8
   pods of 8 with lane 3 dead at round 6 (recovery within its pod) and
   pod 5 (lanes 40-47) at round 10 (recovery across pods).  Each explores
   every node exactly once, leaves the dead lanes empty, and matches the
   JAX package's pinned rounds, telemetry summary, per-lane carry, final
   sizes and digests of the proportion history, rings and cursors; K1 and
   K4 launch 2 times a round flat and 4 times in pods, K3 and K2 once a
   worker body.  ms per round of the unarmed, the armed flat and the armed
   hierarchical runtime, drained in turns.  (c) ``run_resilient`` crashes
   at round 6, restarts from the snapshot of round 4 and lands on (a)'s
   rings, cursors and round count; a flat snapshot of round 8 restores
   into a hierarchical runtime, which finishes the drain.  (d) ``shrink``
   64 -> 56 lanes and ``grow`` back, and a live resize of a runtime padded
   from 48 to 64 lanes, keep the exact item multiset, and the live resize
   leaves ``compile_count`` unchanged (a count that cannot move until the
   port captures CUDA graphs: it says only that the library is loaded).
9. One lane per process (``{"phase": "mesh"}``, after phase 8;
   ``repro_torch.distributed``).  (a) 8 ranks under ``gloo``, all on the
   one card, run ``parallel_solve(execution="mesh")`` on phase 3's
   instance and geometry with 8 workers (phase 3 stacks 64; one card
   hosts 8 ranks): every rank must return the JAX package's integers
   (``PHASE9_EXPECT``, ``scripts/mesh_pins.py``) and the stacked 8-lane
   run's in this process, and each rank must launch the fused explore,
   K3, K2, K1 and K4 once per dispatched round on its own lane (K2 once
   more on rank 0, the seed push).  (b) Phase 2's backlog on 8 ranks, 8
   supersteps, compact and dense, flat and in 2 pods of 4: digests of the
   rings, ``lo``, sizes and telemetry equal the stacked runtime's on the
   card.  (c) ``parallel_solve(n_workers=1, execution="mesh")`` under
   ``nccl`` equals the stacked run at one lane.  (d) The decode engine
   with one lane per rank (``DecodeCluster(execution="mesh")``, reduced
   llama3.2-1b in float32, ``PHASE9_DECODE``) in the same spawn,
   steal-balanced and with migration: every rank's served tokens, request
   stamps and scheduling integers equal the stacked 8-lane run's.  ms per
   superstep and per decode round on the mesh and stacked, not gated;
   gloo stages each collective through the host (the line names the
   transport).
10. Continuous-batching decode (``{"phase": "decode"}``, after the serving
   phases; ``repro_torch.serve.decode``).  llama3.2-1b at its published
   widths and depth, bf16, random weights from seed 0, behind
   ``DecodeCluster``: 4 lanes of 128 queued requests, 8 slots a lane, KV
   pages of 16 rows (40 a lane and a trash page), 64 requests of 1-64
   prompt tokens (teacher-forced one a round) and 1-16 new tokens drawn
   as ``benchmarks/serve_decode.py`` draws them, 16 arriving a step.
   Four drains: steal-balanced on the stacked lanes (``vmap``) and on the
   host master (``host``), the static round-robin baseline and in-flight
   migration.  Every request gets exactly its tokens; each run's rounds,
   steals, migrations, stalls and request-stamp digest equal the JAX
   package's (``PHASE10_EXPECT``, ``scripts/decode_pins.py``); the
   balanced runs steal, the static one moves nothing, the migrating one
   migrates; ``vmap`` and ``host`` serve the same tokens; K3 (the body's
   admission pop) launches once a round, and K1 and K4 (the superstep)
   once a round in the stacked-master runs, K2 once per admitted lane
   group.  The stacked balanced and migrating runs again in float32 at
   the same widths (their integers pinned too), and every token they
   served held against a per-request greedy decode on the
   scalar-position path: each within ``2 * 1e-4 * (1 + max |logit|)`` of
   that decode's greedy logit.  ms per round, tokens/s, SLO percentiles
   in rounds and the load spread, not gated.
11. Training and the rest of ``DecoderLM`` (``{"phase": "train"}``, after
   phase 10; ``PHASE11``), random weights from seed 0, float32
   parameters, bf16 compute, remat.  (a) llama3.2-1b at its published
   widths and depth: the first step's loss and gradients in float32
   through K6's SIMT kernel against the plain version's (loss 1e-4, each
   leaf 1e-3 of its largest |g|), then 12 steps of ``make_train_step`` on
   one repeated 4 x 1,024 batch of ``launch/train``'s pipeline: finite
   losses, the last below the first, every gradient leaf of the first
   step finite and the attention projections' non-zero in every layer
   (a launch autograd could not see would leave them at zero), K6 32
   launches a step (16 forward, 16 recomputed; the backward is the plain
   version's), all on the tensor-core kernel.  (b) qwen3-moe-30b-a3b at
   its widths, 8 of 48 layers, served in phase 4's setup with the
   routing counted: phase 4's gates, the bulk steal rerouting > 0
   assignments and dropping none, its plan on the card bit-equal to the
   CPU's, the first wave's float32 logits within 1e-4 of the plain
   versions' under one routing plan (flips counted); then one train step
   at 2 layers, every leaf's gradient finite.  (c) mamba2-2.7b, 8 of 64
   layers, 2 x 1,024: the float32 comparison (K7's SIMT kernel) and one
   bf16 step, K7 16 launches a step.  (d) internvl2-2b at its depth: one
   prefill of 4 prompts behind their 256 patches, K6 once a layer, the
   float32 logits within 1e-4 of the plain version's.  ms a step,
   tokens/s and peak memory, not gated.
12. The enc-dec family (``{"phase": "encdec"}``, after phase 11;
   ``PHASE12``): seamless-m4t-medium at its published widths and depth.
   (a) A bf16 prefill of 4 utterances of 1,000 seeded stub frames with
   256-token target prefixes: K6 36 times (12 encoder, 12 decoder self,
   12 cross-attention, counted by mode), all on the tensor-core kernel;
   16 greedy decode steps; in float32 the prefill logits through K6
   within 1e-4 of its plain version's, the bf16 prefill's mean distance
   from float32 at most 1.1x the plain bf16 prefill's, and 4 float32
   decode steps after the kernel prefill and after the plain one within
   1e-4.  (b) 8 train steps on one repeated 4 x (1,024 frames, 1,024
   tokens) batch, the pipeline's tokens behind seeded frames (float32
   parameters, bf16 compute, remat): K6 72
   launches a step, the float32 first step on seeded frames against the
   plain step (loss 1e-4, each leaf 1e-3 of its largest |g|), every
   layer's encoder, decoder and cross-attention projections with a
   non-zero gradient, the loss falling.  The kernels line's
   ``flash_attention_cross`` row is K6 at (a)'s cross-attention shape.
13. The sharded-model path (``{"phase": "sharded"}``, after phase 12;
   ``PHASE13``): 8 gloo ranks on the one card as a (data 2, model 4)
   model mesh, every collective staged through the host.  (a)
   Flash-decoding, llama3.2-1b at its widths and depth in bf16: each data
   rank prefills its 8 of 16 seeded 2,500-token prompts through K6,
   grows the cache to 8,192 and keeps its model rank's 2,048 positions;
   16 teacher-forced steps against the unsharded decode of the same rows
   in this process: no NaN, and every rank's mean distance from the
   float32 decode of the same parameters at most 1.1x the unsharded bf16
   decode's (the distance past atol = rtol = 3e-2 reported); then
   float32 at 4 of 16 layers, every logit within 1e-4.  (b) Expert parallelism,
   qwen3-moe-30b-a3b at its widths, 2 of 48 layers, float32: each model
   rank holds 32 of 128 experts; each data rank's prefill of 8 prompts
   of 256 tokens within 2e-5 + 2e-4 |x| of the whole dispatch on the same
   rows, its routing plans bit-equal.  ms per decode step and per
   prefill, sharded and unsharded, not gated.

14. Observability (``{"phase": "obs"}``, after phase 13;
   ``repro_torch.obs``).  Phase 8's flat and hierarchical DAG replays
   again, each drained with and without a phase probe
   (``attach_phase_probe()``), in turns, three times: (a) the probed runs
   equal ``PHASE8_EXPECT`` (bit-identity with the probe on); (b) K1-K4
   launch as often as in the unprobed replay; (c) ``phase_summary()``
   times every round run and estimates none, every phase total is >= 0,
   the fractions sum to 1 within 1e-9, and the rounds' attributed time is
   at most the drain's wall; (d) ``rt.metrics()``'s Prometheus text gives
   ``repro_rounds_total``, ``repro_steals_total`` and
   ``repro_items_transferred_total`` equal to the pinned summary's; (e)
   ``export_trace`` of the probed flat stream passes ``validate_trace``;
   (f) ``run_resilient(metrics_path=...)`` over a probed flat drain on
   the card writes a textfile equal to a final ``rt.metrics()``; (g)
   ``ServeCluster.metrics()`` after phase 4 counts every request phase 4
   served in ``repro_serve_served_total``.  ms per round probed and
   unprobed, the ratio of their medians and the four phase fractions of
   each replay, not gated (the phases are device-timeline times from
   CUDA events; the drain's wall is host time).

15. The sharded step (``{"phase": "sharded_step"}``, after phase 14;
   ``with mesh.spmd():``, ``PHASE15``).  Each case's unsharded reference
   on the card, then one spawn of 8 gloo ranks of the card: (a)
   llama3.2-1b at full width and depth, float32, 8 x 256 on (data 2,
   model 4), two AdamW steps: every rank's losses within 1e-5 (1 +
   |loss|) of the unsharded steps', its first step's gradient blocks
   within 1e-4 of each leaf's largest |g|, a prefill's logits within
   1e-4, K6 32 launches a step and 16 a prefill on every rank; (b)
   qwen3-moe-30b-a3b (2 layers) and mamba2-2.7b (4 layers), one step
   each, the same gates, K6 4 / K7 8 a step, the MoE's routing plans the
   unsharded dispatch's of the same router probabilities bit for bit;
   (c) llama3.2-1b (4 layers) on (pod 2, data 2, model 2); (d)
   ``launch.dryrun.trace_cell`` of (a)'s step on a recording mesh: its
   collective log equal to rank 0's, call for call (gated), its
   arguments plus temporaries beside rank 0's ``max_memory_allocated``;
   (e) ``run_cell("llama3.2-1b", "train_4k")`` printed whole, with the
   card's ``total_memory``.  ms a step sharded and unsharded, not gated.

16. The examples (``{"phase": "examples"}``, after phase 15;
   ``PHASE16``).  The port's four ``examples/torch_*.py`` on the card, each
   a subprocess at its default size: the quickstart (its bulk push and
   steal launch K2 and K1, its vmapped superstep K1 and K4), the knapsack
   solver (``bnb.solve`` and ``parallel_solve`` must equal the DP
   oracle), the serving demo (every request served behind the straggler,
   the master stole, K6 launched) and the LM trainer (the loss falls, K6
   launched).  Each must exit 0; its exit code, wall seconds and the
   integers it printed are reported.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

# The solver's geometry (the repo's LFQConfig: 16,384-row rings, max_steal
# 8,192; 64 workers, a point of the Fig. 10 sweep; explore width 16 x batch
# 8 = 128-row child pushes, 8-row pops).
LANES, CAP, MAX_STEAL, PUSH_ROWS, POP_ROWS = 64, 16384, 8192, 128, 8
# the ring geometry phase 1 times K1-K4 at (lanes, rows, max_steal, rows a
# push, rows a pop)
RING = (LANES, CAP, MAX_STEAL, PUSH_ROWS, POP_ROWS)
# The paper's Fig. 6 sweep of push sizes, up to max_steal rows per lane.
FIG6_PUSH_ROWS = (1, 16, 128, 1024, 8192)

# What the JAX package's parallel_solve returns for PHASE3 (a CPU run of
# repro.core.dd.parallel.parallel_solve at commit ebd45d9, jax 0.9.0, all
# four ops on its kernel routing): optimum 1260 (= dp_solve), 44
# supersteps, 15,968 subproblems explored, 6,850 items transferred in 472
# steals.
PHASE3 = dict(n_items=30, seed=3, n_workers=LANES, explore_width=16,
              batch=8, capacity=CAP, max_steal=MAX_STEAL)
PHASE3_EXPECT = dict(optimum=1260, supersteps=44, explored=15968,
                     transferred=6850, steals=472)

# Phase 4: the repo's default serving arch (launch/serve.py) at full
# width; the two-replica straggler setup of examples/serve_demo.py.
PHASE4 = dict(arch="llama3.2-1b", n_requests=24, prompt_lens=(128, 1024),
              max_new=16, max_seq=1040, wave_size=4, slow_speed=0.25)
# The first wave's prefill through K6 against the same prefill through its
# plain version.  In float32 compute they must agree to 1e-4 (the port's
# float32 logits tolerance against the JAX package).  In bfloat16 compute
# at this width two correct attentions that round differently already
# differ by more than tests/test_serve.py's 2e-2 (see
# scripts/prefill_precision.py: the plain version's own bf16 logits sit
# 0.11 from its float32 ones), so there K6 must be as accurate as its
# plain version: its mean distance from the float32 logits at most 1.1x
# the plain's.
# Phase 5: the SSM family's serving path, mamba2-2.7b at full size, in
# phase 4's setup.  Phase 6: the hybrid, zamba2-7b, one wave of 4.
PHASE5 = dict(PHASE4, arch="mamba2-2.7b")
PHASE6 = dict(arch="zamba2-7b", n_prompts=4, prompt_lens=(128, 1024),
              max_new=8, max_seq=1040)
SERVE_TOL_F32 = 1e-4
SERVE_TOL_BF16 = 2e-2  # reported: share of logits outside it
SERVE_BF16_RATIO = 1.1
SHARDED_BF16_WITNESS_RATIO = 2.0

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
# The sequential solver (``bnb.solve``) on PHASE3's instance at its
# defaults (width 32, batch 16): what the JAX package's
# repro.core.dd.bnb.solve returns in a CPU run (commit bc2d671, jax 0.9.0).
PHASE3B = dict(n_items=30, seed=3, width=32, batch=16)
PHASE3B_EXPECT = dict(optimum=1260, explored=8781, pruned=7976,
                      generated=8781, supersteps=550)
# The resilience phase: phase 2's geometry (64 int32 lanes of 16,384
# rows, max_steal 8,192), the Fig. 9 DAG of tests/test_resilience.py at
# 262,144 nodes (fan-out 4, pops of 128) from one item on lane 0, drained
# in blocks of 16 rounds; (a) flat under kill / delay / drop, (b) in 8
# pods of 8 with lane 3 dead at round 6 and pod 5 (lanes 40-47) at 10.
PHASE8 = dict(
    lanes=LANES, capacity=CAP, max_steal=MAX_STEAL, n_nodes=262144,
    fanout=4, pop=128, block=16, pod_size=8,
    policy=dict(proportion=0.5, low_watermark=4, high_watermark=32),
    flat_plan=dict(kills=((3, 6),), delays=((17, 4, 4),), drops=(8,)),
    hier_plan=dict(kills=((3, 6),) + tuple((w, 10) for w in range(40, 48)),
                   delays=((17, 4, 4),), drops=(8,)))
# The CPU rehearsal's size (tests/test_torch_smoke.py).
PHASE8_SMALL = dict(
    PHASE8, lanes=8, capacity=256, max_steal=64, n_nodes=600, pop=16,
    pod_size=4,
    flat_plan=dict(kills=((3, 6),), delays=((5, 4, 4),), drops=(8,)),
    hier_plan=dict(kills=((1, 6), (4, 10), (5, 10), (6, 10), (7, 10)),
                   delays=((2, 3, 2),), drops=(9,)))
# What the JAX package returns for PHASE8 (scripts/resilience_pins.py, a
# CPU run at commit bc2d671, jax 0.9.0): history, rings and lo are
# SHA-256 digests of the float32 proportion history, the rings and the lo
# cursors.
PHASE8_EXPECT = {
    "flat": dict(
        rounds=46,
        summary={"rounds": 46, "steals": 293, "items_transferred": 51691,
            "bytes_transferred": 206764, "bytes_moved": 1376256,
            "proportion_mean": 0.3314742659745009, "proportion_final":
            0.578439474105835, "imbalance_final": 0.0, "straggler_steps": 0,
            "faults": {"planned_kill": 1}},
        carry=[4477, 4451, 4711, 180, 4660, 4648, 4784, 4540, 4469, 4171,
            4577, 4477, 4623, 4415, 4433, 4299, 4173, 3985, 4225, 4380, 4272,
            4213, 4186, 4363, 4236, 4097, 4166, 4110, 3727, 4239, 4293, 4017,
            4254, 3981, 4051, 3985, 3842, 4139, 4163, 4132, 3963, 4127, 4043,
            3760, 4072, 4003, 3945, 3898, 3811, 4080, 4156, 4282, 4180, 3881,
            3689, 3934, 3837, 3688, 3730, 3932, 3849, 4005, 4456, 3679],
        sizes=[0] * 64,
        history="139e784d584c3470", history_len=47,
        rings="e08149583bb558d8", lo="12cb843fad323bc7"),
    "hier": dict(
        rounds=82,
        summary={"rounds": 82, "steals": 551, "items_transferred": 72469,
            "bytes_transferred": 289876, "bytes_moved": 4128768,
            "proportion_mean": 0.43298117689243176, "proportion_final":
            0.749976396560669, "imbalance_final": 0.0, "straggler_steps": 0,
            "faults": {"planned_kill": 9}},
        carry=[8006, 8327, 7909, 90, 7613, 7780, 7563, 7271, 6901, 6454, 5919,
            4917, 4683, 4164, 4505, 3966, 7357, 6996, 6410, 5854, 5196, 5057,
            4947, 5143, 6008, 4954, 4186, 3104, 2790, 2480, 2782, 2435, 6697,
            5243, 3943, 3839, 3264, 3696, 3896, 3239, 144, 191, 0, 0, 0, 0, 0, 0,
            5799, 4187, 3352, 2645, 2413, 2320, 2415, 2184, 6407, 5274, 4346,
            3621, 3122, 3127, 2577, 2436],
        sizes=[0] * 64,
        history="9000d66e6e7513c9", history_len=83,
        rings="4bf3c98d6eb3c8ce", lo="5f3c43e51895c24d"),
}
# Phase 9: one lane per process (repro_torch.distributed).  (a) phase 3's
# instance and geometry through parallel_solve(execution="mesh") on 8
# lanes, one per rank — 8 gloo ranks share the one card, so 8 lanes where
# phase 3 stacks 64; (b) phase 2's backlog on 8 ranks (the even lanes
# holding 10,000 items each, 8 supersteps at proportion 0.5), compact and
# dense, flat and in 2 pods of 4; (c) one rank under nccl (NCCL refuses
# two ranks on one device), on a 20-item instance of phase 3's seed.
PHASE9 = dict(
    solver=dict(n_items=30, seed=3, n_workers=8, explore_width=16, batch=8,
                capacity=CAP, max_steal=MAX_STEAL),
    backlog=dict(lanes=8, capacity=CAP, backlog=10000, max_steal=MAX_STEAL,
                 rounds=8, pod_size=4),
    single=dict(n_items=20, seed=3, n_workers=1, explore_width=16, batch=8,
                capacity=CAP, max_steal=MAX_STEAL),
    single_backend="nccl", timeout=600)
# The CPU rehearsal's size (tests/test_torch_smoke.py): 4 gloo CPU ranks,
# and gloo in (c).
PHASE9_SMALL = dict(
    solver=dict(n_items=16, seed=3, n_workers=4, explore_width=4, batch=2,
                capacity=1024, max_steal=1024),
    backlog=dict(lanes=4, capacity=256, backlog=100, max_steal=64, rounds=8,
                 pod_size=2),
    single=dict(n_items=14, seed=3, n_workers=1, explore_width=4, batch=2,
                capacity=256, max_steal=256),
    single_backend="gloo", timeout=240)
# What the JAX package's parallel_solve returns for PHASE9's solver
# (scripts/mesh_pins.py, a CPU run at commit e6b620b, jax 0.9.0).
PHASE9_EXPECT = dict(optimum=1260, supersteps=267, explored=16335,
                     transferred=3823, steals=107,
                     per_worker_explored=[2056, 2053, 2036, 2059, 2019, 2042,
                                          2047, 2023])

# Phase 10: continuous-batching decode (repro_torch.serve.decode) with
# llama3.2-1b at its published widths and depth: 4 lanes of 128 queued
# requests, 8 slots a lane, prompts up to 64 tokens teacher-forced one a
# round, up to 16 new tokens, pages of 16 KV rows (5 a sequence, 40 a
# lane).  64 requests drawn as benchmarks/serve_decode.py's _request_mix
# draws them (seed 0), arriving 16 a step as its _drain submits them.
# Four runs: steal-balanced on stacked lanes and on the host master, the
# static round-robin baseline, and in-flight migration.  The straggler
# monitor is off (it reads the wall clock, which would make the schedule
# depend on the host's speed).
PHASE10 = dict(arch="llama3.2-1b", n_lanes=4, capacity=128,
               policy=dict(n_slots=8, max_prompt=64, max_new=16,
                           page_size=16),
               n_requests=64, arrival=16, seed=0)
PHASE10_RUNS = (
    ("vmap", dict(execution="vmap")),
    ("host", dict(execution="host")),
    ("static", dict(execution="vmap", balance=False, admission="rr")),
    ("migrate", dict(execution="vmap", steal="migrate")))
# The runs held, in float32 at the same widths, against a per-request
# greedy decode on the scalar-position path (decode_reference): the
# stacked balanced run and the migrating one, whose pages move between
# lanes.  Float32 because at this width two correct bfloat16 decodes
# round apart by more than a near-tie between logits.
PHASE10_REFERENCE = ("vmap", "migrate")
# The CPU rehearsal (tests/test_torch_decode.py): the same mix, policy and
# runs on reduced llama3.2-1b in float32.  The scheduling integers read no
# model output, so they are the card's.
PHASE10_SMALL = dict(PHASE10, reduced=True, compute_dtype="float32")
# What the JAX package's DecodeCluster returns for PHASE10's runs
# (scripts/decode_pins.py, a CPU run at reduced width at commit e641585,
# jax 0.9.0): rounds,
# items stolen, migrations, stalls and a SHA-256 digest of the sorted
# (rid, admit, first, finish) stamps of every request.
PHASE10_EXPECT = {
    "vmap": dict(rounds=113, stolen=3, migrated=0, stalls=0,
                 stamps="1da5e044080d733b"),
    "host": dict(rounds=113, stolen=3, migrated=0, stalls=0,
                 stamps="1da5e044080d733b"),
    "static": dict(rounds=113, stolen=0, migrated=0, stalls=0,
                   stamps="6294710d4fba644a"),
    "migrate": dict(rounds=113, stolen=3, migrated=38, stalls=0,
                    stamps="5655bd39654c1ef8"),
}
# Phase 9's decode check: DecodeCluster(execution="mesh") on the mesh's
# ranks (reduced llama3.2-1b, float32, serve_decode.py's tiny mix: 28
# requests of prompts up to 8 and up to 8 new tokens, in one burst, 2
# slots a lane so that queues form, pages of 4), steal-balanced and with
# migration, against the stacked run.
PHASE9_DECODE = dict(arch="llama3.2-1b", capacity=128,
                     policy=dict(n_slots=2, max_prompt=8, max_new=8,
                                 page_size=4),
                     n_requests=28, arrival=28, seed=0, reduced=True,
                     compute_dtype="float32")

# Phase 11: training, and the MoE and VLM branches of DecoderLM, at
# published widths.  (a) llama3.2-1b at its depth: float32 parameters,
# bf16 compute, remat, 12 steps of make_train_step on one repeated 4 x
# 1,024 batch of launch/train's pipeline, after the first step's loss and
# gradients in float32 against the plain versions'.  (b)
# qwen3-moe-30b-a3b cut to 8 of 48 layers served in phase 4's setup (the
# bulk-steal routing counted), then one train step at 2 layers.  (c)
# mamba2-2.7b cut to 8 of 64 layers, one bf16 step on 2 x 1,024 after the
# float32 comparison.  (d) internvl2-2b at its depth, one prefill of 4
# prompts of 768 tokens behind their 256 patches.
_STEP = dict(lr=1e-3, warmup_steps=2, seed=0)
PHASE11 = dict(
    dense=dict(_STEP, arch="llama3.2-1b", batch=4, seq=1024, steps=12,
               compare=True),
    moe=dict(arch="qwen3-moe-30b-a3b", n_layers=8,
             serve=dict(n_requests=24, prompt_lens=(128, 1024), max_new=16,
                        max_seq=1040, wave_size=4, slow_speed=0.25),
             train=dict(_STEP, arch="qwen3-moe-30b-a3b", layers=2, batch=2,
                        seq=1024, steps=1)),
    ssm=dict(_STEP, arch="mamba2-2.7b", layers=8, batch=2, seq=1024,
             steps=1, compare=True),
    vlm=dict(arch="internvl2-2b", n_prompts=4, text_len=768, seed=0))
# The CPU rehearsal (tests/test_torch_smoke.py): reduced widths.
PHASE11_SMALL = dict(
    reduced=True,
    dense=dict(PHASE11["dense"], batch=2, seq=32, steps=4),
    moe=dict(PHASE11["moe"], n_layers=2,
             serve=dict(n_requests=10, prompt_lens=(8, 24), max_new=4,
                        max_seq=30, wave_size=4, slow_speed=0.25),
             train=dict(PHASE11["moe"]["train"], seq=32)),
    ssm=dict(PHASE11["ssm"], seq=40),
    vlm=dict(PHASE11["vlm"], text_len=12))
# Phase 12: the enc-dec family, seamless-m4t-medium at its published
# widths and depth (12 + 12 layers, d 1,024, 16 heads of 64, vocab
# 256,206), random weights from seed 0.  (a) bf16 prefill of 4 utterances
# of 1,000 stub frames with target prefixes of 256 tokens, 16 greedy
# decode steps, the float32 comparisons over 4; (b) 8 train steps on one
# repeated 4 x (1,024 frames, 1,024 tokens) batch of launch/train's
# pipeline (float32 parameters, bf16 compute, remat).
PHASE12 = dict(
    serve=dict(arch="seamless-m4t-medium", batch=4, frames=1000,
               prefix=256, new=16, f32_steps=4, seed=0),
    train=dict(_STEP, arch="seamless-m4t-medium", batch=4, seq=1024,
               steps=8, compare=True))
# The CPU rehearsal (tests/test_torch_smoke.py): reduced widths.
PHASE12_SMALL = dict(
    reduced=True,
    serve=dict(PHASE12["serve"], frames=40, prefix=12, new=4, f32_steps=2),
    train=dict(PHASE12["train"], batch=2, seq=32, steps=3))
# Phase 13: the sharded-model path on 8 gloo ranks of the one card, a
# (data 2, model 4) model mesh.  (a) flash-decoding: llama3.2-1b at its
# widths and depth in bf16, 16 seeded prompts of 2,500 tokens, each data
# rank prefilling its 8 rows, the cache grown to 8,192 (_SEQ_SHARD_MIN,
# so the branch is taken without moving the threshold) and sliced 2,048
# a model rank, 16 teacher-forced steps against the unsharded decode of
# the same rows.  In bf16 at this width two correct decodes of the same
# rows round apart by more than the JAX package's 3e-2
# (tests/test_perf_variants.py, set at reduced width): the unsharded
# decode of 8 rows and of all 16 lie ~0.1 apart.  So, as phase 4 does,
# the bf16 run must be as accurate as the unsharded one: its mean
# distance from the float32 decode of the same parameters at most 1.1x
# the unsharded bf16 decode's, and each rank's largest distance from the
# unsharded decode within 3e-2 or at most 2x that of the two unsharded
# decodes (on the CPU they agree exactly, and 3e-2 holds).  Then
# in float32 at 4 of 16 layers within 1e-4.  (b) expert parallelism:
# qwen3-moe-30b-a3b at its widths (128 experts of 768, top-8), 2 of 48
# layers, float32, 16 prompts of 256 tokens, 32 experts a model rank.
_FLASH13 = dict(arch="llama3.2-1b", batch=16, prompt=2500, cache=8192,
                steps=16, seed=0, param_dtype="bfloat16",
                compute_dtype="bfloat16", tol=3e-2)
PHASE13 = dict(
    mesh=((2, 4), ("data", "model")), timeout=900,
    flash=dict(_FLASH13, f32_reference=True),
    flash_f32=dict(_FLASH13, layers=4, param_dtype="float32",
                   compute_dtype="float32", tol=1e-4),
    moe=dict(arch="qwen3-moe-30b-a3b", layers=2, batch=16, prompt=256,
             seed=0, param_dtype="float32", compute_dtype="float32"))
# The CPU rehearsal: reduced widths on 8 gloo CPU ranks, the threshold
# lowered to 16 as the JAX package's own test lowers it.
PHASE13_SMALL = dict(
    PHASE13, reduced=True, timeout=240, seq_shard_min=16,
    flash=dict(_FLASH13, prompt=24, cache=40, steps=3, f32_reference=True),
    flash_f32=dict(PHASE13["flash_f32"], prompt=24, cache=40, steps=3,
                   layers=None),
    moe=dict(PHASE13["moe"], prompt=12, layers=None))

# Phase 15: the sharded step (``with mesh.spmd():``) on 8 gloo ranks of
# the one card.  (a) llama3.2-1b at its widths and depth, float32, 8 rows
# of 256 tokens on a (data 2, model 4) mesh: two AdamW steps, each rank's
# loss within SHARDED_LOSS_TOL x (1 + |loss|) of the unsharded step's on
# the same card and parameters (made from the seed on the card), its
# first step's gradient blocks within SHARDED_GRAD_TOL of each leaf's
# largest |g|, and a prefill's logits within SHARDED_LOGITS_TOL; K6
# launching on every rank's 8 query heads, twice a layer a step (the
# forward and the remat's recompute).  (b) qwen3-moe-30b-a3b (2 of 48
# layers; 128 experts, 32 a model rank) and mamba2-2.7b (4 of 64 layers)
# at their widths, one step each, the same gates, the MoE's routing
# plans bit-equal to the unsharded dispatch's.  (c) llama3.2-1b on a
# (pod 2, data 2, model 2) mesh, one step, its depth cut to 4 of 16
# layers (at 16 a rank's quarter of the parameters and of AdamW's old and
# new state is ~9 GB, and 8 ranks do not fit beside the reference).  (d)
# the dry run's trace of (a)'s step on a recording mesh: its collective
# log equal to rank 0's (gated), its arguments plus temporaries beside
# rank 0's max_memory_allocated.  (e) launch.dryrun.run_cell of
# llama3.2-1b x train_4k on the 16 x 16 mesh, printed whole.
_STEP15 = dict(batch=8, seq=256, steps=1, seed=0, param_dtype="float32",
               compute_dtype="float32",
               opt=dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6))
PHASE15 = dict(
    mesh=((2, 4), ("data", "model")),
    pod_mesh=((2, 2, 2), ("pod", "data", "model")), timeout=900,
    dense=dict(_STEP15, arch="llama3.2-1b", steps=2, prefill=True),
    pods=dict(_STEP15, arch="llama3.2-1b", layers=4),
    moe=dict(_STEP15, arch="qwen3-moe-30b-a3b", layers=2),
    ssm=dict(_STEP15, arch="mamba2-2.7b", layers=4),
    run_cell=("llama3.2-1b", "train_4k"))
# The CPU rehearsal: reduced widths, 32 tokens a row.
PHASE15_SMALL = dict(
    PHASE15, reduced=True, timeout=300,
    dense=dict(PHASE15["dense"], seq=32),
    pods=dict(PHASE15["pods"], seq=32, layers=None),
    moe=dict(PHASE15["moe"], seq=32, layers=None),
    ssm=dict(PHASE15["ssm"], seq=32, layers=None), run_cell=None)
# Phase 16: the examples' arguments (their defaults on the card) and the
# CPU rehearsal's smaller ones.
PHASE16 = dict(quickstart=[], knapsack_solver=[], serve_demo=[], train_lm=[],
               timeout=300)
PHASE16_SMALL = dict(
    quickstart=[], knapsack_solver=["--n", "10"],
    serve_demo=["--requests", "6"],
    train_lm=["--steps", "4", "--layers", "2", "--d-model", "256",
              "--vocab", "512", "--seq", "32", "--batch", "2"],
    timeout=120)
SHARDED_LOSS_TOL = 1e-5
SHARDED_GRAD_TOL = 1e-4
SHARDED_LOGITS_TOL = 1e-4
# Where the sharded and the unsharded forwards route a token to other
# experts, the unsharded top-k boundary must be a near-tie: float32
# router inputs that round apart by ~1e-6 flip no wider gap.
PLAN_TIE_GAP = 1e-4

# Float32 loss and gradients through the kernels (their SIMT routes)
# against the plain versions': the loss to 1e-4 (+ relative), as
# serving's float32 logits; each gradient leaf to 1e-3 of its largest
# |g| (the forward activations differ by the kernels' float32 rounding,
# ~1e-6 relative, and the backward carries that through every layer).
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3

# int32 operations: half the data sheet's 67 TFLOP/s float32 rate outside
# the tensor cores, as a Hopper SM has 64 int32 lanes to 128 float32 ones
# (NVIDIA's Hopper architecture white paper).
PEAK_INT32_OPS = 33.5e12

KERNELS = (
    ("ring_gather", "src/repro_torch/kernels/queue_steal/ring_gather.cu",
     "src/repro/kernels/queue_steal/kernel.py:56"),
    ("ring_scatter", "src/repro_torch/kernels/queue_push/ring_push.cu",
     "src/repro/kernels/queue_push/kernel.py:85"),
    ("ring_slice", "src/repro_torch/kernels/queue_push/ring_slice.cu",
     "src/repro/kernels/queue_push/kernel.py:155"),
    ("ring_transfer",
     "src/repro_torch/kernels/queue_transfer/ring_transfer.cu",
     "src/repro/kernels/queue_transfer/kernel.py:79"),
    # K5's redesign, the fused DD explore (K5 per layer is its earlier
    # design, timed beside it)
    ("dd_expand", "src/repro_torch/kernels/dd_expand/explore.cu",
     "src/repro/kernels/dd_expand/kernel.py:53"),
    ("flash_attention",
     "src/repro_torch/kernels/flash_attention/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention/kernel.py:100"),
    # the same kernel at zamba2-7b's head dim, timed at its prefill shape
    ("flash_attention_hd112",
     "src/repro_torch/kernels/flash_attention/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention/kernel.py:100"),
    # the same kernel unmasked at seamless-m4t-medium's cross-attention
    # (S 256 against T 1,000), timed at its prefill shape
    ("flash_attention_cross",
     "src/repro_torch/kernels/flash_attention/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention/kernel.py:100"),
    ("ssd_scan", "src/repro_torch/kernels/ssd_scan/ssd_scan_wgmma.cu",
     "src/repro/kernels/ssd_scan/kernel.py:80"),
    # the same kernel at zamba2-7b's state width, timed at its prefill shape
    ("ssd_scan_hd64_ns64",
     "src/repro_torch/kernels/ssd_scan/ssd_scan_wgmma.cu",
     "src/repro/kernels/ssd_scan/kernel.py:80"),
)


def _port():
    """The kernel library and the launch counters of the solver path's
    kernels (``dd_expand``: K5's redesign, the fused explore), imported
    late: the script must fail cleanly where there is no GPU or no checkout
    around it."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels._lib as lib
    from repro_torch.kernels.dd_expand import ops as expand_ops
    from repro_torch.kernels.queue_push import ops as push_ops
    from repro_torch.kernels.queue_steal import ops as steal_ops
    from repro_torch.kernels.queue_transfer import ops as transfer_ops
    return lib, {"ring_gather": steal_ops.steal_gather,
                 "ring_scatter": push_ops.push_scatter,
                 "ring_slice": push_ops.pop_slice,
                 "ring_transfer": transfer_ops.transfer_splice,
                 "dd_expand": expand_ops.explore_fused}


# each launch counter's kernel, as the profiler's device events name it
COUNTED_KERNELS = {"ring_gather": "ring_gather_kernel",
           "ring_scatter": "ring_scatter_kernel",
           "ring_slice": "ring_slice_kernel",
           "ring_transfer": "ring_transfer_kernel",
           "dd_expand": "explore_kernel", "dd_expand_layer": "expand_kernel"}


def _off_path():
    """Launch counters of kernels the solver path must not launch: K5 per
    layer, the fused explore's earlier design."""
    from repro_torch.kernels.dd_expand import ops as expand_ops
    return {"dd_expand_layer": expand_ops.expand_pool}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------- timing


class Timer:
    """Per-call time of a function on ``device``.  On a GPU: CUDA events
    around ``n`` calls queued behind a device-side sleep, so the events
    see the device time of the calls and not the host's launch rate
    (``clean`` says whether the host finished queueing before the sleep
    ended).  On the CPU (tests) it is host time, and never reported.
    ``reps`` caps the calls timed (and the three warm-up calls) of every
    measurement, for a quick rehearsal; None times each as asked."""

    def __init__(self, device, reps=None):
        import torch
        self.torch, self.device, self.reps = torch, device, reps
        self.cycles_per_ms = None
        if device.type == "cuda":
            e0, e1 = self._events(2)
            torch.cuda.synchronize()
            e0.record()
            torch.cuda._sleep(10 ** 7)
            e1.record()
            torch.cuda.synchronize()
            self.cycles_per_ms = 10 ** 7 / e0.elapsed_time(e1)

    def _events(self, k):
        return [self.torch.cuda.Event(enable_timing=True) for _ in range(k)]

    def ms(self, fn, n: int = 100):
        torch = self.torch
        if self.reps is not None:
            n = min(n, self.reps)
        for _ in range(min(3, n)):
            fn()
        if self.device.type != "cuda":
            t = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t) * 1e3 / n, True
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        # A host slower than the sleep (a shared host, clocks that ramp
        # after the calibration) leaves the events timing its launch
        # rate: sleep longer and time again.
        for _ in range(4):
            e0, e1, e2 = self._events(3)
            e0.record()
            torch.cuda._sleep(int(self.cycles_per_ms * (2 * host_ms + 5)))
            e1.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            host_ms = (time.perf_counter() - t) * 1e3
            e2.record()
            torch.cuda.synchronize()
            clean = host_ms < e0.elapsed_time(e1)
            if clean:
                break
        return e1.elapsed_time(e2) / n, clean


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------- phase 1: the kernels


def _bits(t):
    import torch
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[
        t.element_size()])


def _compare(kernel_out, plain_out, what: str) -> float:
    """Bit-exact check; returns the max abs difference (0.0)."""
    check(kernel_out.shape == plain_out.shape
          and kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype")
    same = bool((_bits(kernel_out) == _bits(plain_out)).all())
    err = float((kernel_out.double() - plain_out.double()).abs().max()) \
        if kernel_out.numel() else 0.0
    check(same, f"{what}: kernel differs from its plain version "
                f"(max abs err {err})")
    return err


def _vec(device, x):
    import torch
    return torch.tensor(np.asarray(x, np.int32).reshape(-1), device=device)


def _at_offset(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` elements into its
    storage, so its base can sit off a 16-byte boundary."""
    import torch
    flat = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


def _ring(device, rng, lanes, rows, d, dtype, offset: int = 0):
    """A seeded ``(lanes, rows, d)`` payload, ``offset`` elements into its
    storage."""
    from repro_torch.kernels import cases as C
    t = C.to_tensor(C.payload(rng, (lanes, rows, d), dtype), dtype, device)
    return _at_offset(t, offset) if offset else t


def _gather_case(device, rng, lanes, cap, d, m, lo, n, dtype, what,
                 offset=0):
    from repro_torch.kernels.queue_steal.ops import ring_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    buf = _ring(device, rng, lanes, cap, d, dtype, offset)
    lo, n = _vec(device, lo), _vec(device, n)
    return ("ring_gather", what, ring_gather(buf, lo, n, m),
            ring_gather_ref(buf, lo, n, m))


def _transfer_case(device, rng, lanes, cap, d, src_rows, m, head, src, n,
                   dtype, what, offsets=(0, 0)):
    """K4 from a flat ``(src_rows, d)`` stack (``W * m`` rows for a
    stack of windows)."""
    from repro_torch.kernels.queue_transfer.ops import ring_transfer
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref
    buf = _ring(device, rng, lanes, cap, d, dtype, offsets[0])
    gathered = _ring(device, rng, 1, src_rows, d, dtype, offsets[1])[0]
    head, src, n = _vec(device, head), _vec(device, src), _vec(device, n)
    plain = ring_transfer_ref(buf, gathered, head, src.long() * m,
                              n.clamp(0, min(m, cap)))
    return ("ring_transfer", what,
            ring_transfer(_at_offset(buf, offsets[0]), gathered, head, src, n,
                          m), plain)


def _scatter_case(device, rng, lanes, cap, d, b, start, n, dtype, what,
                  offsets=(0, 0)):
    """K2 from a ``(lanes, b, d)`` batch; ring and batch ``offsets``
    elements into their storage."""
    from repro_torch.kernels.queue_push.ops import ring_scatter
    from repro_torch.kernels.queue_push.ref import ring_scatter_ref
    buf = _ring(device, rng, lanes, cap, d, dtype, offsets[0])
    batch = _ring(device, rng, lanes, b, d, dtype, offsets[1])
    start, n = _vec(device, start), _vec(device, n)
    plain = ring_scatter_ref(buf, batch, start, n.clamp(0, min(b, cap)))
    return ("ring_scatter", what,
            ring_scatter(_at_offset(buf, offsets[0]), batch, start, n), plain)


def byte_cases(device, rng):
    """K1, K2 and K4 on their byte path: the byte case tables, bases off a
    16-byte boundary, and a stack whose last window is short (rows past
    it repeat its last row)."""
    from repro_torch.kernels import cases as C
    for cap, d, m, lo, n, dt in C.STEAL_BYTE_CASES:
        yield _gather_case(device, rng, len(lo), cap, d, m, lo, n, dt,
                           f"bytes {cap},{d},{m},{dt}")
    for cap, d, m, start, n, dt in C.SCATTER_BYTE_CASES:
        yield _scatter_case(device, rng, len(start), cap, d, m, start, n, dt,
                            f"bytes {cap},{d},{m},{dt}")
    for cap, d, w, m, head, src, n, dt in C.TRANSFER_BYTE_CASES:
        yield _transfer_case(device, rng, len(head), cap, d, w * m, m, head,
                             src, n, dt, f"bytes {cap},{d},{w},{m},{dt}")
    for dt, d, off in (("int32", 1, 1), ("int32", 3, 3), ("bfloat16", 3, 1),
                       ("bfloat16", 1, 5)):
        lo = rng.integers(-100, 100, 4)
        yield _gather_case(device, rng, 4, 100, d, 70, lo,
                           rng.integers(0, 71, 4), dt,
                           f"base +{off} elements {d},{dt}", off)
        yield _transfer_case(device, rng, 4, 100, d, 3 * 70, 70, lo,
                             rng.permutation(4) % 3, rng.integers(0, 71, 4),
                             dt, f"bases +{off}/+{off + 2} elements {d},{dt}",
                             (off, off + 2))
        yield _scatter_case(device, rng, 4, 100, d, 70, lo,
                            rng.integers(0, 71, 4), dt,
                            f"bases +{off}/+{off + 2} elements {d},{dt}",
                            (off, off + 2))
    yield _transfer_case(device, rng, 3, 64, 3, 40, 16, (60, 5, 9), (2, 1, 3),
                         (16, 16, 5), "int32", "short last window")


def tree_cases(device, rng, leaves):
    """K1 and K4 on one payload tree at ``cases.TREE_CASE``'s geometry,
    through the tree wrappers (one launch per eight leaves): yields
    ``(kernel name, what, kernel_out, plain_out)`` per leaf."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.queue_steal.ops import steal_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    from repro_torch.kernels.queue_transfer.ops import transfer_splice
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

    cap, m, w, start, n, src = C.TREE_CASE
    lanes = len(start)

    def tree(lead):
        return {k: C.to_tensor(a, leaves[k][1], device)
                for k, a in C.tree_payload(rng, lead, leaves).items()}

    rings, stacks = tree((lanes, cap)), tree((w, m))
    start, n, src = _vec(device, start), _vec(device, n), _vec(device, src)
    what = f"tree of {len(leaves)} leaves"
    got = steal_gather(rings, start, n, max_steal=m)
    for k, ring in rings.items():
        yield ("ring_gather", f"{what}: {k}", got[k],
               ring_gather_ref(ring, start, n, m))
    spliced = transfer_splice({k: v.clone() for k, v in rings.items()},
                              stacks, start, src, n, max_steal=m)
    for k, ring in rings.items():
        flat = stacks[k].reshape((w * m,) + tuple(stacks[k].shape[2:]))
        yield ("ring_transfer", f"{what}: {k}", spliced[k],
               ring_transfer_ref(ring, flat, start, src.long() * m,
                                 n.clamp(0, min(m, cap))))


def slice_tree_cases(device, rng, leaves):
    """K3 on one payload tree at ``cases.SLICE_TREE_CASE``'s geometry,
    through the tree wrapper (one launch per eight leaves): yields
    ``(kernel name, what, kernel_out, plain_out)`` per leaf."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.queue_push.ops import pop_slice
    from repro_torch.kernels.queue_push.ref import ring_slice_ref

    cap, m, lo, size, n = C.SLICE_TREE_CASE
    rings = {k: C.to_tensor(a, leaves[k][1], device)
             for k, a in C.tree_payload(rng, (len(lo), cap), leaves).items()}
    lo, size, n = (_vec(device, c) for c in (lo, size, n))
    got = pop_slice(rings, lo, size, n, max_n=m)
    for k, ring in rings.items():
        yield ("ring_slice", f"tree of {len(leaves)} leaves: {k}", got[k],
               ring_slice_ref(ring, lo, size, n, m))


def scatter_tree_cases(device, rng, leaves):
    """K2 on one payload tree at ``cases.SCATTER_TREE_CASE``'s geometry,
    through the tree wrapper (one launch per eight leaves): yields
    ``(kernel name, what, kernel_out, plain_out)`` per leaf."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.queue_push.ops import push_scatter
    from repro_torch.kernels.queue_push.ref import ring_scatter_ref

    cap, m, start, n = C.SCATTER_TREE_CASE

    def tree(lead):
        return {k: C.to_tensor(a, leaves[k][1], device)
                for k, a in C.tree_payload(rng, lead, leaves).items()}

    rings, batches = tree((len(start), cap)), tree((len(start), m))
    start, n = _vec(device, start), _vec(device, n)
    got = push_scatter({k: v.clone() for k, v in rings.items()}, batches,
                       start, n)
    live = n.clamp(0, min(m, cap))
    for k, ring in rings.items():
        yield ("ring_scatter", f"tree of {len(leaves)} leaves: {k}", got[k],
               ring_scatter_ref(ring, batches[k], start, live))


def many_leaves():
    """Twelve leaves (``cases.TREE_LEAVES`` four times): two launches."""
    from repro_torch.kernels import cases as C
    return {f"{k}{i}": v for i in range(4) for k, v in C.TREE_LEAVES.items()}


def kernel_cases(device, rng):
    """Yield ``(kernel name, what, kernel_out, plain_out)`` over the case
    tables, the ring kernels' byte path and payload trees, and the
    solver's geometry in float32, int32 and bfloat16."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.queue_push.ops import ring_slice
    from repro_torch.kernels.queue_push.ref import ring_slice_ref

    def vec(x):
        return _vec(device, x)

    def ring(lanes, cap, d, dtype):
        return _ring(device, rng, lanes, cap, d, dtype)

    def gather(lanes, cap, d, m, lo, n, dtype, what):
        return _gather_case(device, rng, lanes, cap, d, m, lo, n, dtype, what)

    def scatter(lanes, cap, d, b, start, n, dtype, what):
        return _scatter_case(device, rng, lanes, cap, d, b, start, n, dtype,
                             what)

    def slice_(lanes, cap, d, m, lo, size, n, dtype, what):
        buf = ring(lanes, cap, d, dtype)
        lo, size, n = vec(lo), vec(size), vec(n)
        return ("ring_slice", what, ring_slice(buf, lo, size, n, m),
                ring_slice_ref(buf, lo, size, n, m))

    def transfer(lanes, cap, d, w, m, head, src, n, dtype, what):
        return _transfer_case(device, rng, lanes, cap, d, w * m, m, head,
                              src, n, dtype, what)

    for cap, d, m, lo, n, dt in C.STEAL_CASES:
        yield gather(1, cap, d, m, lo, n, dt, f"table {cap},{d},{m},{dt}")
    for cap, d, b, start, n, dt in C.SCATTER_CASES:
        yield scatter(1, cap, d, b, start, n, dt, f"table {cap},{d},{b},{dt}")
    for cap, d, m, lo, size, n, dt in C.SLICE_CASES:
        yield slice_(1, cap, d, m, lo, size, n, dt,
                     f"table {cap},{d},{m},{dt}")
    for cap, d, w, m, head, src, n, dt in C.TRANSFER_CASES:
        yield transfer(1, cap, d, w, m, head, src, n, dt,
                       f"table {cap},{d},{w},{m},{dt}")
    yield from byte_cases(device, rng)
    yield from tree_cases(device, rng, C.TREE_LEAVES)
    yield from tree_cases(device, rng, many_leaves())
    yield from slice_tree_cases(device, rng, C.TREE_LEAVES)
    yield from slice_tree_cases(device, rng, many_leaves())
    yield from scatter_tree_cases(device, rng, C.TREE_LEAVES)
    yield from scatter_tree_cases(device, rng, many_leaves())
    for dt in ("float32", "int32", "bfloat16"):
        lo = rng.integers(0, CAP, LANES)
        size = rng.integers(0, CAP + 1, LANES)
        yield gather(LANES, CAP, 1, MAX_STEAL, lo,
                     rng.integers(0, MAX_STEAL + 1, LANES), dt, f"path {dt}")
        yield scatter(LANES, CAP, 1, PUSH_ROWS, lo,
                      rng.integers(0, PUSH_ROWS + 1, LANES), dt, f"path {dt}")
        yield slice_(LANES, CAP, 1, POP_ROWS, lo, size,
                     np.minimum(size, rng.integers(0, POP_ROWS + 1, LANES)),
                     dt, f"path {dt}")
        yield transfer(LANES, CAP, 1, LANES, MAX_STEAL, lo,
                       rng.permutation(LANES),
                       rng.integers(0, MAX_STEAL + 1, LANES), dt,
                       f"path {dt}")


def kernel_timings(device, rng, timer, ring=None):
    """Per kernel at ``ring``'s geometry (default :data:`RING`, the
    solver's; int32 rows, every lane moving its full count): kernel, plain
    version and library call times and the device-memory bound."""
    lanes, cap, max_steal, push_rows, pop_rows = ring or RING
    import torch
    from repro_torch.kernels.queue_push.ops import ring_scatter, ring_slice
    from repro_torch.kernels.queue_push.ref import (ring_scatter_ref,
                                                    ring_slice_ref)
    from repro_torch.kernels.queue_steal.ops import ring_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    from repro_torch.kernels.queue_transfer.ops import ring_transfer
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

    i32 = torch.int32
    buf = torch.tensor(rng.integers(0, 2 ** 30, (lanes, cap, 1)), dtype=i32,
                       device=device)
    flat = buf.view(lanes * cap, 1)
    base = torch.arange(lanes, device=device)[:, None] * cap
    lo = torch.tensor(rng.integers(0, cap, lanes), dtype=i32, device=device)
    size = torch.tensor(rng.integers(pop_rows, cap + 1, lanes), dtype=i32,
                        device=device)

    def rows_of(start, m):
        return (base + (start.long()[:, None]
                        + torch.arange(m, device=device)) % cap).reshape(-1)

    full_steal = torch.full((lanes,), max_steal, dtype=i32, device=device)
    full_push = torch.full((lanes,), push_rows, dtype=i32, device=device)
    full_pop = torch.full((lanes,), pop_rows, dtype=i32, device=device)
    batch = torch.tensor(rng.integers(0, 2 ** 30, (lanes, push_rows, 1)),
                         dtype=i32, device=device)
    gathered = torch.tensor(rng.integers(0, 2 ** 30, (lanes * max_steal, 1)),
                            dtype=i32, device=device)
    src = torch.tensor(rng.permutation(lanes), dtype=i32, device=device)
    win_idx = rows_of(lo, max_steal)
    pop_idx = rows_of(lo + size - pop_rows, pop_rows)
    push_idx = rows_of(lo, push_rows)
    # src is a permutation, so window s lands in the one lane l with
    # src[l] == s: row s * max_steal + i of the stack goes to lane l's
    # physical row (lo[l] + i) % cap.
    splice_idx = win_idx.view(lanes, max_steal)[
        torch.argsort(src.long())].reshape(-1)
    cursor = 4 * lanes

    specs = {
        # the compact exchange's window: every lane reads max_steal rows
        "ring_gather": (
            lambda: ring_gather(buf, lo, full_steal, max_steal),
            lambda: ring_gather_ref(buf, lo, full_steal, max_steal),
            lambda: flat.index_select(0, win_idx),
            2 * lanes * max_steal * 4 + 2 * cursor,
            "window at lo, n = max_steal on every lane"),
        "ring_scatter": (
            lambda: ring_scatter(buf, batch, lo, full_push),
            lambda: ring_scatter_ref(buf, batch, lo, full_push),
            lambda: flat.index_copy_(0, push_idx, batch.view(-1, 1)),
            2 * lanes * push_rows * 4 + 2 * cursor,
            f"{push_rows}-row push on every lane"),
        "ring_slice": (
            lambda: ring_slice(buf, lo, size, full_pop, pop_rows),
            lambda: ring_slice_ref(buf, lo, size, full_pop, pop_rows),
            lambda: flat.index_select(0, pop_idx),
            2 * lanes * pop_rows * 4 + 3 * cursor,
            f"{pop_rows}-row pop on every lane"),
        "ring_transfer": (
            lambda: ring_transfer(buf, gathered, lo, src, full_steal,
                                  max_steal),
            lambda: ring_transfer_ref(buf, gathered, lo,
                                      src.long() * max_steal, full_steal),
            lambda: flat.index_copy_(0, splice_idx, gathered),
            2 * lanes * max_steal * 4 + 3 * cursor,
            "max_steal rows from the window stack into every lane"),
    }
    # The library yardsticks compute the same function on these inputs.
    check(torch.equal(specs["ring_gather"][2]().view(lanes, max_steal, 1),
                      ring_gather(buf, lo, full_steal, max_steal)),
          "index_select yardstick != ring_gather")
    check(torch.equal(specs["ring_slice"][2]().view(lanes, pop_rows, 1),
                      ring_slice(buf, lo, size, full_pop, pop_rows)),
          "index_select yardstick != ring_slice")
    pushed = ring_scatter(buf.clone(), batch, lo, full_push)
    check(torch.equal(flat.clone().index_copy_(0, push_idx, batch.view(-1, 1)),
                      pushed.view(lanes * cap, 1)),
          "index_copy_ yardstick != ring_scatter")
    spliced = ring_transfer(buf.clone(), gathered, lo, src, full_steal,
                            max_steal)
    check(torch.equal(flat.clone().index_copy_(0, splice_idx, gathered),
                      spliced.view(lanes * cap, 1)),
          "index_copy_ yardstick != ring_transfer")
    out = {}
    for name, (kern, plain, library, nbytes, what) in specs.items():
        ms, clean = timer.ms(kern)
        plain_ms, plain_clean = timer.ms(plain, n=20)
        lib_ms = timer.ms(library)[0]
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                         bound_by="bytes", bound_bytes=nbytes, timed_at=what,
                         device_time_clean=clean and plain_clean)
    return out


def solver_payload_timings(device, rng, timer, ring=None):
    """K1-K4 as the solver calls them, on its payload tree of three int32
    leaves (layer, state, value) of 64 x 16,384-row rings (``ring``,
    default :data:`RING`): K1 reads the
    compact exchange's window (n = max_steal on every lane), K2 pushes a
    128-row batch of children with n drawn in 0-128 on every lane, K3 pops
    8 rows on every lane, K4 splices a superstep's mean transfer, 15 rows
    into each of 11 of the 64 lanes (phase 3 moves 6,850 rows in 472
    steals over 44 supersteps).
    One call of the tree wrapper each, checked bit for bit against the
    plain versions leaf by leaf; ``launches_per_call`` counts the
    wrapper's launches in one call.  No single PyTorch call moves a
    tree."""
    lanes, cap, max_steal, push_rows, pop_rows = ring or RING
    import torch
    from repro_torch.kernels.queue_push.ops import pop_slice, push_scatter
    from repro_torch.kernels.queue_push.ref import (ring_scatter_ref,
                                                    ring_slice_ref)
    from repro_torch.kernels.queue_steal.ops import steal_gather
    from repro_torch.kernels.queue_steal.ref import ring_gather_ref
    from repro_torch.kernels.queue_transfer.ops import transfer_splice
    from repro_torch.kernels.queue_transfer.ref import ring_transfer_ref

    thieves, rows = min(11, lanes), min(15, max_steal)

    def leaves(shape):
        return {k: torch.tensor(rng.integers(0, 2 ** 30, shape),
                                dtype=torch.int32, device=device)
                for k in ("layer", "state", "value")}

    rings, stacks = leaves((lanes, cap)), leaves((lanes, max_steal))
    lo = _vec(device, rng.integers(0, cap, lanes))
    full = _vec(device, np.full(lanes, max_steal))
    n = np.zeros(lanes, np.int32)
    n[rng.choice(lanes, thieves, replace=False)] = rows
    n = _vec(device, n)
    src = _vec(device, rng.permutation(lanes))
    size = _vec(device, rng.integers(pop_rows, cap + 1, lanes))
    pop = _vec(device, np.full(lanes, pop_rows))
    children = leaves((lanes, push_rows))
    push_n = _vec(device, rng.integers(0, push_rows + 1, lanes))
    cursor = 4 * lanes
    specs = {
        "ring_gather": (
            lambda t: steal_gather(t, lo, full, max_steal=max_steal),
            lambda t: {k: ring_gather_ref(v, lo, full, max_steal)
                       for k, v in t.items()},
            3 * (2 * lanes * max_steal * 4) + 2 * cursor,
            "the solver's 3 int32 leaves, window at lo, n = max_steal on "
            "every lane"),
        "ring_scatter": (
            lambda t: push_scatter(t, children, lo, push_n),
            lambda t: {k: ring_scatter_ref(v, children[k], lo, push_n)
                       for k, v in t.items()},
            3 * (2 * int(push_n.sum()) * 4) + 2 * cursor,
            f"the solver's 3 int32 leaves, {push_rows}-row batch, n in "
            f"0-{push_rows} on every lane"),
        "ring_slice": (
            lambda t: pop_slice(t, lo, size, pop, max_n=pop_rows),
            lambda t: {k: ring_slice_ref(v, lo, size, pop, pop_rows)
                       for k, v in t.items()},
            3 * (2 * lanes * pop_rows * 4) + 3 * cursor,
            f"the solver's 3 int32 leaves, {pop_rows}-row pop on every "
            f"lane"),
        "ring_transfer": (
            lambda t: transfer_splice(t, stacks, lo, src, n,
                                      max_steal=max_steal),
            lambda t: {k: ring_transfer_ref(v, stacks[k].view(-1), lo,
                                            src.long() * max_steal, n)
                       for k, v in t.items()},
            3 * (2 * thieves * rows * 4) + 3 * cursor,
            f"the solver's 3 int32 leaves, {rows} rows into {thieves} of "
            f"{lanes} lanes"),
    }
    counters = {"ring_gather": steal_gather, "ring_scatter": push_scatter,
                "ring_slice": pop_slice, "ring_transfer": transfer_splice}
    out = {}
    for name, (kern, plain, nbytes, what) in specs.items():
        before = counters[name].launches
        got = kern({k: v.clone() for k, v in rings.items()})
        per_call = counters[name].launches - before
        for k, want in plain(rings).items():
            _compare(got[k], want, f"{name} {what}: {k}")
        ms, clean = timer.ms(lambda: kern(rings))
        plain_ms, plain_clean = timer.ms(lambda: plain(rings), n=20)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                         bound_by="bytes", bound_bytes=nbytes, timed_at=what,
                         launches_per_call=per_call,
                         device_time_clean=clean and plain_clean)
    return out


def push_latency(device, rng, timer, *, lanes=LANES, cap=CAP,
                 sizes=FIG6_PUSH_ROWS):
    """The paper's Fig. 6 on the card: K2's time per push of ``m`` rows on
    every one of ``lanes`` int32 rings of ``cap`` rows (every lane pushes
    its full batch), beside ``index_copy_`` of the same rows and the byte
    bound, for each ``m`` in ``sizes``.  Each size is first held bit for
    bit against the plain version, and the yardstick against K2."""
    import torch
    from repro_torch.kernels.queue_push.ops import ring_scatter
    from repro_torch.kernels.queue_push.ref import ring_scatter_ref

    i32 = torch.int32
    buf = torch.tensor(rng.integers(0, 2 ** 30, (lanes, cap, 1)), dtype=i32,
                       device=device)
    flat = buf.view(lanes * cap, 1)
    lo = torch.tensor(rng.integers(0, cap, lanes), dtype=i32, device=device)
    base = torch.arange(lanes, device=device)[:, None] * cap
    series = []
    for m in sizes:
        batch = torch.tensor(rng.integers(0, 2 ** 30, (lanes, m, 1)),
                             dtype=i32, device=device)
        rows = batch.view(-1, 1)
        n = torch.full((lanes,), m, dtype=i32, device=device)
        idx = (base + (lo.long()[:, None] + torch.arange(m, device=device))
               % cap).reshape(-1)
        got = ring_scatter(buf.clone(), batch, lo, n)
        _compare(got, ring_scatter_ref(buf, batch, lo, n),
                 f"ring_scatter push of {m} rows")
        check(torch.equal(flat.clone().index_copy_(0, idx, rows),
                          got.view(-1, 1)),
              f"index_copy_ yardstick != ring_scatter at {m} rows")
        ms, clean = timer.ms(lambda: ring_scatter(buf, batch, lo, n))
        lib_ms, lib_clean = timer.ms(lambda: flat.index_copy_(0, idx, rows))
        nbytes = 2 * lanes * m * 4 + 2 * 4 * lanes
        series.append(dict(max_push=m, ms=ms, library_ms=lib_ms,
                           bound_ms=nbytes / MEM_BYTES_PER_S * 1e3,
                           bound_bytes=nbytes,
                           device_time_clean=clean and lib_clean))
    return {"lanes": lanes, "capacity": cap, "dtype": "int32",
            "series": series}


def _flash_inputs(device, rng, case):
    from repro_torch.kernels import cases as C
    B, S, T, H, K, hd, _, _, _, dtype = case
    return [C.to_tensor(C.payload(rng, shape, dtype), dtype, device)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


def _close(kernel_out, plain_out, tol: float, what: str,
           rtol: float | None = None) -> float:
    """``|kernel - plain| <= tol + rtol * |plain|`` everywhere (the JAX
    package's assert_allclose; ``rtol`` defaults to ``tol``); returns the
    max abs difference."""
    import torch
    rtol = tol if rtol is None else rtol
    check(kernel_out.shape == plain_out.shape
          and kernel_out.dtype == plain_out.dtype, f"{what}: shape/dtype")
    a, b = kernel_out.float(), plain_out.float()
    diff = (a - b).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = torch.isfinite(a).all() and (diff <= tol + rtol * b.abs()).all()
    check(bool(ok), f"{what}: kernel differs from its plain version (max "
                    f"abs err {err}, tolerance {tol} + {rtol} x |plain|)")
    return err


def flash_checks(device, rng, shapes):
    """K6 against its plain version on the case tables and at ``shapes``
    (bfloat16 through the tensor-core kernel, float32 through the SIMT
    kernel); returns (max abs err, number of cases)."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref

    err, cases = 0.0, (C.FLASH_CASES + C.FLASH_EXTRA_CASES
                       + C.FLASH_RAGGED_CASES + list(shapes))
    for case in cases:
        B, S, T, H, K, hd, causal, window, cap, dtype = case
        q, k, v = _flash_inputs(device, rng, case)
        kw = dict(causal=causal, window=window, softcap=cap)
        err = max(err, _close(mha(q, k, v, **kw), attention_ref(q, k, v, **kw),
                              C.FLASH_TOL[dtype], f"flash_attention {case}"))
    return err, len(cases)


def flash_timing(device, rng, timer, shape):
    """K6 (through ``mha``'s route for the shape's dtype), its earlier bf16
    design (the SIMT kernel, ``mha_simt``), its plain version and SDPA,
    each checked against the plain version within tolerance first, at
    ``shape`` (causal with S == T, or unmasked at any S and T), and the
    bound: the larger of 4 hd flops per visible (q, k) pair per head at
    the dense bf16 tensor-core peak and q, k, v and o's bytes at the
    memory rate."""
    import torch.nn.functional as F
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.flash_attention.ops import mha, mha_simt
    from repro_torch.kernels.bounds import flash_counts
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, S, T, H, K, hd, causal, window, cap, dtype = shape
    check((S == T or not causal) and window is None and cap is None,
          "SDPA computes K6's function only unmasked, or causal at S == T")
    q, k, v = _flash_inputs(device, rng, shape)
    kw = dict(causal=causal, window=window, softcap=cap)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True).transpose(1, 2)

    plain = attention_ref(q, k, v, **kw)
    tol = C.FLASH_TOL[dtype]
    err = _close(mha(q, k, v, **kw), plain, tol, f"flash_attention {shape}")
    _close(mha_simt(q, k, v, **kw), plain, tol, f"SIMT kernel {shape}")
    _close(library(), plain, tol, f"SDPA yardstick {shape}")
    flops, nbytes = flash_counts(B, S, T, H, K, hd, causal=causal,
                                 window=window, itemsize=q.element_size())
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ms, clean = timer.ms(lambda: mha(q, k, v, **kw))
    earlier_ms, earlier_clean = timer.ms(lambda: mha_simt(q, k, v, **kw),
                                         n=20)
    plain_ms, plain_clean = timer.ms(lambda: attention_ref(q, k, v, **kw),
                                     n=20)
    return dict(ms=ms, earlier_ms=earlier_ms, plain_ms=plain_ms,
                library_ms=timer.ms(library)[0],
                bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes",
                bound_flops=flops, bound_bytes=nbytes, shape_max_abs_err=err,
                timed_at=f"B {B}, S {S}, T {T}, H {H}, K {K}, hd {hd}, "
                         f"{dtype}, {'causal' if causal else 'unmasked'}",
                device_time_clean=clean and earlier_clean and plain_clean)


def _expand_inputs(device, rng, shape, tensor_scalars: bool, wp=(3, 8)):
    import torch
    from repro_torch.kernels import cases as C
    s, v = C.expand_inputs(rng, shape, device)
    if tensor_scalars:  # as the solver passes them: 0-d views on the card
        wp = tuple(torch.tensor(list(wp), dtype=torch.int32, device=device))
    return s, v, *wp


def expand_checks(device, rng):
    """K5 against its plain version, bit for bit, on the JAX package's
    table (``(N,)`` nodes, Python-int w and p) and at the solver's pools
    (``(512, 16)``, w and p 0-d int32 tensors); returns (max abs err,
    number of cases)."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.dd_expand.ops import (expand_layer_bulk,
                                                   expand_pool)
    from repro_torch.kernels.dd_expand.ref import expand_ref

    runs = [(expand_layer_bulk, (n,), False, wp) for n, wp in C.EXPAND_CASES]
    runs += [(expand_pool, C.EXPAND_SOLVER, True, wp)
             for wp in ((3, 8), (50, 1), (0, 0))]
    err = 0.0
    for fn, shape, tensors, wp in runs:
        args = _expand_inputs(device, rng, shape, tensors, wp)
        for k_out, p_out in zip(fn(*args), expand_ref(*args)):
            err = max(err, _compare(k_out, p_out,
                                    f"dd_expand {shape} {wp}"))
    return err, len(runs)


def expand_timing(device, rng, timer):
    """K5 and its plain version at the solver's pools; the bound is the
    bytes (each node's state and value read, four children written)."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.dd_expand.ops import expand_pool
    from repro_torch.kernels.dd_expand.ref import expand_ref

    args = _expand_inputs(device, rng, C.EXPAND_SOLVER, True)
    nbytes = 6 * args[0].numel() * 4 + 8
    ms, clean = timer.ms(lambda: expand_pool(*args))
    plain_ms, plain_clean = timer.ms(lambda: expand_ref(*args), n=20)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, bound_by="bytes",
                bound_bytes=nbytes,
                timed_at=f"{C.EXPAND_SOLVER[0]} pools of "
                         f"{C.EXPAND_SOLVER[1]} nodes, w and p on the card",
                device_time_clean=clean and plain_clean)


def _explore_args(device, rng, case):
    """``(subproblems, valid, weights, profits)`` of an ``EXPLORE_CASES``
    entry, on ``device``."""
    import torch
    from repro_torch.core.dd.bnb import Subproblem
    from repro_torch.kernels import cases as C
    x = {k: torch.from_numpy(v).to(device)
         for k, v in C.explore_inputs(rng, case).items()}
    return (Subproblem(x["layer"], x["state"], x["value"]), x["valid"],
            x["weights"], x["profits"])


def _compare_explore(got, want, what: str) -> float:
    err = 0.0
    for k in ("primal", "dual", "exact"):
        err = max(err, _compare(got[k], want[k], f"{what} {k}"))
    for f in ("layer", "state", "value"):
        err = max(err, _compare(getattr(got["children"], f),
                                getattr(want["children"], f),
                                f"{what} children {f}"))
    return err


def explore_checks(device, rng):
    """K5's redesign, the fused DD explore (``bnb.explore_batch``), against
    its plain version (``bnb.explore_batch_plain``) bit for bit on
    ``cases.EXPLORE_CASES``; returns (max abs err, number of cases)."""
    from repro_torch.core.dd.bnb import explore_batch, explore_batch_plain
    from repro_torch.kernels import cases as C

    err = 0.0
    for case in C.EXPLORE_CASES:
        args = _explore_args(device, rng, case)
        kw = dict(width=case[2], n_vars=case[3])
        err = max(err, _compare_explore(explore_batch(*args, **kw),
                                        explore_batch_plain(*args, **kw),
                                        f"explore {case[0]}"))
    return err, len(C.EXPLORE_CASES)


def explore_ops(subs, valid, out, *, width: int, n_vars: int) -> int:
    """Integer operations the explore of these subproblems needs: for each
    valid one, the layers its restricted and relaxed DDs walk (from its
    start layer to the end) and its exact DD walks (to its first overflow,
    which sets its children's layer), each layer of a pool costing 4 per
    child for the arcs (2W children) and two sorts of the 2W children, 2W
    log2(2W) comparisons each: the merge of duplicate states and the top-k
    by value."""
    import torch
    first = subs.layer.clamp(min=0).long().cpu()
    walk = (n_vars - first).clamp(min=0)
    stop = out["children"].layer.amax(-1).long().cpu() + 1
    exact_walk = torch.where(out["exact"].cpu(), walk, stop - first)
    layers = int((2 * walk + exact_walk)[valid.cpu()].sum())
    k = 2 * width
    return layers * (4 * k + 2 * k * int(np.ceil(np.log2(k))))


def explore_timing(device, rng, timer, batch=None):
    """The fused explore and its plain version on the solver's batch
    (``EXPLORE_CASES[0]``: 512 subproblems, width 16, 30 layers; ``batch``
    subproblems of its kind instead where given), checked
    bit for bit first, and the bound: the larger of the bytes (the (B,)
    inputs, weights and profits read once, the bounds, flags and (B, W)
    children written once) at the memory rate and :func:`explore_ops` at
    the int32 rate; no single PyTorch call computes the explore."""
    from repro_torch.core.dd.bnb import explore_batch, explore_batch_plain
    from repro_torch.kernels import cases as C

    case = C.EXPLORE_CASES[0]
    if batch is not None:
        case = case[:1] + (batch,) + case[2:]
    what, b, width, n_vars = case[:4]
    args = _explore_args(device, rng, case)
    kw = dict(width=width, n_vars=n_vars)
    plain = explore_batch_plain(*args, **kw)
    _compare_explore(explore_batch(*args, **kw), plain, f"explore {what}")
    nbytes = b * (3 * 4 + 1) + 2 * n_vars * 4 + b * (2 * 4 + 1) \
        + 3 * b * width * 4
    ops = explore_ops(args[0], args[1], plain, **kw)
    byte_ms = nbytes / MEM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_INT32_OPS * 1e3
    ms, clean = timer.ms(lambda: explore_batch(*args, **kw))
    plain_ms, plain_clean = timer.ms(lambda: explore_batch_plain(*args, **kw),
                                     n=5)
    # The plain version's ~5,000 launches a call fill the launch queue
    # behind the timer's sleep, so its time is the host's launch rate:
    # its flag is reported apart from the kernel's.
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=max(byte_ms, op_ms),
                bound_by="operations" if op_ms >= byte_ms else "bytes",
                bound_bytes=nbytes, bound_ops=ops,
                timed_at=f"{b} subproblems ({int(args[1].sum())} valid), "
                         f"width {width}, {n_vars} layers",
                device_time_clean=clean,
                plain_device_time_clean=plain_clean)


def ssd_cases(shapes):
    """K7's parity cases: the case tables, bfloat16 copies of the JAX
    package's table (the bfloat16 route at its shapes), and ``shapes`` in
    their dtype and in float32."""
    from repro_torch.kernels import cases as C
    return C.SSD_CASES + [c[:-1] + ("bfloat16",) for c in C.SSD_CASES] \
        + C.SSD_EXTRA_CASES + [s for shape in shapes
                               for s in (shape, shape[:-1] + ("float32",))]


def ssd_checks(device, rng, shapes):
    """K7 against its plain version on :func:`ssd_cases`; returns (max abs
    err, number of cases)."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    err, cases = 0.0, ssd_cases(shapes)
    for case in cases:
        args = C.ssd_inputs(rng, case, device)
        Q, dtype = case[5], case[6]
        atol, rtol = C.SSD_TOL[dtype]
        for what, k_out, p_out in zip(("y", "final state"),
                                      ssd(*args, chunk=Q),
                                      ssd_chunked(*args, Q)):
            err = max(err, _close(k_out, p_out, atol, f"ssd_scan {case} "
                                  f"{what}", rtol=rtol))
    return err, len(cases)


def ssd_bound(case):
    """(flops, bytes) the SSD scan of ``case`` needs
    (``repro_torch.kernels.bounds.ssd_counts``: the count the dry run's
    trace charges too)."""
    from repro_torch.kernels.bounds import ssd_counts
    B, S, nh, hd, ns, Q, dtype = case
    return ssd_counts(B, S, nh, hd, ns, Q, 2 if dtype == "bfloat16" else 4)


def _device_launches(device, fn) -> int:
    """CUDA kernels one call of ``fn`` runs, from the profiler's device
    events (0 on the CPU, which launches none)."""
    import torch
    if device.type != "cuda":
        return 0
    sync(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def ssd_timing(device, rng, timer, shape):
    """K7 (through ``ssd``'s route for the shape), its earlier bf16 design
    (the SIMT kernel, ``ssd_simt``) and its plain version at ``shape``,
    each checked against the plain version within tolerance first, the
    CUDA launches of one call, and the bound from :func:`ssd_bound`; no
    single PyTorch call computes the scan."""
    from repro_torch.kernels import cases as C
    from repro_torch.kernels.ssd_scan.ops import ssd, ssd_simt
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    args = C.ssd_inputs(rng, shape, device)
    B, S, nh, hd, ns, Q, dtype = shape
    atol, rtol = C.SSD_TOL[dtype]
    plain = ssd_chunked(*args, Q)
    err = max(_close(k_out, p_out, atol, f"ssd_scan {shape}", rtol=rtol)
              for k_out, p_out in zip(ssd(*args, chunk=Q), plain))
    for k_out, p_out in zip(ssd_simt(*args, chunk=Q), plain):
        _close(k_out, p_out, atol, f"SIMT kernel {shape}", rtol=rtol)
    flops, nbytes = ssd_bound(shape)
    flop_ms = flops / PEAK_BF16_FLOPS * 1e3
    byte_ms = nbytes / MEM_BYTES_PER_S * 1e3
    per_call = _device_launches(device, lambda: ssd(*args, chunk=Q))
    ms, clean = timer.ms(lambda: ssd(*args, chunk=Q), n=20)
    earlier_ms, earlier_clean = timer.ms(lambda: ssd_simt(*args, chunk=Q),
                                         n=5)
    plain_ms, plain_clean = timer.ms(lambda: ssd_chunked(*args, Q), n=5)
    return dict(ms=ms, earlier_ms=earlier_ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=max(flop_ms, byte_ms),
                bound_by="operations" if flop_ms >= byte_ms else "bytes",
                bound_flops=flops, bound_bytes=nbytes,
                launches_per_call=per_call, shape_max_abs_err=err,
                timed_at=f"B {B}, S {S}, {nh} heads of {hd}, state {ns}, "
                         f"chunk {Q}, {dtype}",
                device_time_clean=clean and earlier_clean and plain_clean)


def phase_kernels(device, seed: int = 0, flash_shapes=None,
                  ssd_shapes=None, ring=None, explore_batch=None, reps=None):
    """Every kernel against its plain version, then timed.  ``flash_shapes``
    are K6's three timed shapes (default: the serving slice's prefill,
    zamba2-7b's and seamless-m4t-medium's cross-attention, reported as
    ``flash_attention``, ``flash_attention_hd112`` and
    ``flash_attention_cross``) and ``ssd_shapes`` K7's (default: the SSM
    slice's prefill and zamba2-7b's, reported as ``ssd_scan`` and
    ``ssd_scan_hd64_ns64``).  The rest of the timed part is sized by
    ``ring`` (K1-K4 and their solver payload; default :data:`RING`),
    ``explore_batch`` (the fused explore's subproblems; default the
    solver's 512) and ``reps`` (the :class:`Timer`'s cap on calls timed;
    default none).  The defaults are the card's; the CPU rehearsal passes
    small ones, and every parity check runs at its own shapes either
    way."""
    from repro_torch.kernels import cases as C
    rng = np.random.default_rng(seed)
    errs, counts = {}, {}
    for name, what, k_out, p_out in kernel_cases(device, rng):
        errs[name] = max(errs.get(name, 0.0),
                         _compare(k_out, p_out, f"{name} {what}"))
        counts[name] = counts.get(name, 0) + 1
    flash_shapes = flash_shapes or (C.FLASH_SLICE, C.FLASH_ZAMBA,
                                    C.FLASH_CROSS)
    ssd_shapes = ssd_shapes or (C.SSD_SLICE, C.SSD_HYBRID)
    # the dd_expand row: K5's redesign, the fused explore, and K5 itself
    fused_err, fused_n = explore_checks(device, rng)
    layer_err, layer_n = expand_checks(device, rng)
    errs["dd_expand"] = max(fused_err, layer_err)
    counts["dd_expand"] = fused_n + layer_n
    errs["flash_attention"], counts["flash_attention"] = flash_checks(
        device, rng, flash_shapes)
    errs["ssd_scan"], counts["ssd_scan"] = ssd_checks(device, rng,
                                                      ssd_shapes)
    sync(device)
    timer = Timer(device, reps=reps)
    timings = kernel_timings(device, rng, timer, ring)
    for name, row in solver_payload_timings(device, rng, timer,
                                            ring).items():
        timings[name]["solver_payload"] = row
    per_layer = expand_timing(device, rng, timer)
    timings["dd_expand"] = dict(explore_timing(device, rng, timer,
                                               explore_batch),
                                earlier_ms=per_layer["ms"],
                                earlier=per_layer)
    flash_rows = ("flash_attention", "flash_attention_hd112",
                  "flash_attention_cross")
    for name, shape in zip(flash_rows, flash_shapes):
        timings[name] = flash_timing(device, rng, timer, shape)
    # the hd 112 and cross rows: their own shape's error, the case tables'
    # count
    for name in flash_rows[1:]:
        errs[name] = timings[name]["shape_max_abs_err"]
        counts[name] = counts["flash_attention"]
    for name, shape in zip(("ssd_scan", "ssd_scan_hd64_ns64"), ssd_shapes):
        timings[name] = ssd_timing(device, rng, timer, shape)
    errs["ssd_scan_hd64_ns64"] = timings["ssd_scan_hd64_ns64"][
        "shape_max_abs_err"]
    counts["ssd_scan_hd64_ns64"] = counts["ssd_scan"]
    return {name: dict(max_abs_err=errs[name], parity_cases=counts[name],
                       **timings[name]) for name, _, _ in KERNELS}


# ------------------------------------------- phase 2: the paper's backlog


def backlog_items(lanes: int, backlog: int, seed: int) -> dict:
    """``backlog`` unique seeded items for each of the even lanes: their
    ids (``layer``) and two random int32 words."""
    rng = np.random.default_rng(seed)
    ids = np.arange(len(range(0, lanes, 2)) * backlog, dtype=np.int32)
    return {"layer": ids,
            "state": rng.integers(0, 2 ** 30, ids.size).astype(np.int32),
            "value": rng.integers(-2 ** 30, 2 ** 30, ids.size).astype(
                np.int32)}


def backlog_runtime(device, items, *, backend, exchange: str, lanes: int,
                    capacity: int, max_steal: int, execution: str = "vmap",
                    pod_size=None):
    """A runtime of the repo's steal policy on ``backend`` with the even
    lanes holding ``items``, ``backlog`` rows each (the seed pushes):
    stacked on ``device``, or one lane per rank (``execution="mesh"``,
    every rank calling this)."""
    import torch
    from repro_torch.configs.paper_lfq import CONFIG
    from repro_torch.core.policy import StealPolicy

    policy = StealPolicy(proportion=CONFIG.steal_proportion,
                         queue_limit=CONFIG.queue_limit,
                         low_watermark=CONFIG.low_watermark,
                         high_watermark=CONFIG.high_watermark,
                         max_steal=max_steal, exchange=exchange)
    spec = {k: torch.zeros((), dtype=torch.int32) for k in items}
    if execution == "mesh":
        from repro_torch.distributed import launch_runtime
        rt = launch_runtime(lanes, capacity, spec, pod_size=pod_size,
                            policy=policy, backend=backend,
                            device=_runtime_device(device, execution))
    else:  # a tree before the mesh has no launch_runtime
        from repro_torch.runtime.executor import StealRuntime
        rt = StealRuntime(lanes, capacity, spec, pod_size=pod_size,
                          policy=policy, backend=backend, device=device)
    full = list(range(0, lanes, 2))
    backlog = items["layer"].size // len(full)
    for j, lane in enumerate(full):
        part = slice(j * backlog, (j + 1) * backlog)
        rt.push(lane, {k: v[part] for k, v in items.items()}, backlog)
    return rt


def phase_queue(device, *, lanes: int, capacity: int, backlog: int,
                max_steal: int, rounds: int, seed: int = 0):
    """``rounds`` supersteps from half the lanes holding ``backlog`` unique
    items, on the kernel backend (compact and dense exchange) and the
    reference backend; all three must agree and conserve every item."""
    from repro_torch.core.ops import queue_to_numpy
    from repro_torch.runtime.telemetry import RoundRecord

    fields = [f.name for f in dataclasses.fields(RoundRecord)]
    items = backlog_items(lanes, backlog, seed)
    runs = {}
    # The first configuration runs twice; its first run only warms up.
    for backend, exchange in (("cuda", "compact"), ("cuda", "compact"),
                              ("cuda", "dense"), ("reference", "compact")):
        rt = backlog_runtime(device, items, backend=backend,
                             exchange=exchange, lanes=lanes,
                             capacity=capacity, max_steal=max_steal)
        sync(device)
        t0 = time.perf_counter()
        rt.run_fused(rounds)
        sync(device)
        wall = time.perf_counter() - t0
        runs[f"{backend}/{exchange}"] = (
            queue_to_numpy(rt.queues),
            [dataclasses.astuple(r) for r in rt.telemetry.rounds], wall)

    q0, rec0, _ = runs["cuda/compact"]
    bytes_moved = fields.index("bytes_moved")
    for name, (q, rec, _) in runs.items():
        for k in items:
            check(np.array_equal(q.buf[k], q0.buf[k]), f"{name}: ring {k}")
        check(np.array_equal(q.lo, q0.lo) and np.array_equal(q.size, q0.size),
              f"{name}: cursors")
        # The exchanges differ only in the payload they account for.
        if name.endswith("dense"):
            rec = [r[:bytes_moved] + r[bytes_moved + 1:] for r in rec]
            ref = [r[:bytes_moved] + r[bytes_moved + 1:] for r in rec0]
        else:
            ref = rec0
        check(rec == ref, f"{name}: round records")
    # Conservation: every (id, state, value) row lives exactly once.
    ids = items["layer"]
    live = [(q0.lo[l] + np.arange(q0.size[l])) % capacity
            for l in range(lanes)]
    got = {k: np.concatenate([q0.buf[k][l][r] for l, r in enumerate(live)])
           for k in items}
    order = np.argsort(got["layer"])
    for k in items:
        check(np.array_equal(got[k][order], items[k]),
              f"items not conserved ({k})")
    moved = sum(r[fields.index("n_transferred")] for r in rec0)
    check(moved > 0, "the backlog supersteps moved nothing")
    return {"lanes": lanes, "capacity": capacity, "backlog": backlog,
            "rounds": rounds, "items": int(ids.size), "moved": int(moved),
            "ms_per_superstep": {k: v[2] * 1e3 / rounds
                                 for k, v in runs.items()}}


# ----------------------------------------- phase 7: the correctness checkers


def checkers_backlog(device, counters, *, lanes: int, capacity: int,
                     backlog: int, max_steal: int, rounds: int,
                     seed: int = 0):
    """Phase 2's backlog on the relaxed backend and on the sanitized kernel
    backend, each against the plain kernel backend, under both exchanges:
    rings and cursors bit-equal, the live-item multiset conserved, no
    violation.  The plain and relaxed backends run three times each in
    turns (ms per superstep of every run); K1 (the optimistic read and the
    window), K2 and K4 are counted over a relaxed run."""
    from repro_torch.analysis import sanitize
    from repro_torch.core.ops import make_ops, queue_to_numpy

    items = backlog_items(lanes, backlog, seed)
    sanitize.reset_violations()
    out = {"ms_per_superstep": {}, "launches_relaxed": {}}
    for exchange in ("compact", "dense"):
        runs = {}
        for name in ("cuda", "relaxed", "relaxed", "cuda", "cuda", "relaxed",
                     "cuda+check"):
            backend = (make_ops("cuda", check=True) if name == "cuda+check"
                       else name)
            rt = backlog_runtime(device, items, backend=backend,
                                 exchange=exchange, lanes=lanes,
                                 capacity=capacity, max_steal=max_steal)
            check(rt.ops.resolved == name.split("+")[0],
                  f"{name}: routing {rt.ops.resolved!r}")
            check(rt._check == name.endswith("check"),
                  f"{name}: sanitizer armed {rt._check}")
            before = sanitize.queues_fingerprint(rt.queues)
            for fn in counters.values():
                fn.launches = 0
            sync(device)
            t0 = time.perf_counter()
            rt.run_fused(rounds)  # raises SanitizerError on a violation
            sync(device)
            wall = time.perf_counter() - t0
            if name == "relaxed":
                out["launches_relaxed"][exchange] = {
                    k: fn.launches for k, fn in counters.items()
                    if k != "dd_expand"}
            sanitize.check_conserved(
                before, sanitize.queues_fingerprint(rt.queues),
                context=f"{name}/{exchange}")
            runs.setdefault(name, []).append(queue_to_numpy(rt.queues))
            out["ms_per_superstep"].setdefault(f"{name}/{exchange}", []) \
                .append(wall * 1e3 / rounds)
        q0 = runs["cuda"][0]
        for name, q in ((n, q) for n, qs in runs.items() for q in qs):
            for k in items:
                check(np.array_equal(q.buf[k], q0.buf[k]),
                      f"{name}/{exchange}: ring {k} differs from cuda's")
            check(np.array_equal(q.lo, q0.lo)
                  and np.array_equal(q.size, q0.size),
                  f"{name}/{exchange}: cursors differ from cuda's")
    check(sanitize.violations() == (),
          f"sanitizer violations: {sanitize.violations()[:3]}")
    if device.type == "cuda":
        n = out["launches_relaxed"]
        check(n["compact"]["ring_gather"] > 0 and n["dense"]["ring_gather"] > 0,
              "K1 never launched under the relaxed backend")
        check(n["compact"]["ring_transfer"] > 0,
              "K4 never launched under the relaxed backend")
    return out


def checkers_linearize(device, counter, *, geometries=((4, 2), (8, 4))):
    """The exhaustive model checker on ``device``: every history of the
    reference, kernel and relaxed backends at the pinned counts, none
    violating, and every seeded reconcile mutation caught."""
    from repro_torch.analysis import linearize

    backends = ("reference", "cuda", "relaxed")
    counts = {}
    counter.launches = 0
    sync(device)
    t0 = time.perf_counter()
    total, bad = linearize.check_all(backends, geometries=geometries,
                                     device=device, counts=counts)
    caught = linearize.run_mutations(device=device)
    sync(device)
    wall = time.perf_counter() - t0
    for (backend, cap, ms), n in counts.items():
        check(n == linearize.expected_histories(backend),
              f"linearize {backend} at ({cap}, {ms}): {n} histories")
    check(not bad, f"linearize: {len(bad)} violating histories, e.g. "
                   f"{bad[:1]}")
    check(all(n > 0 for n in caught.values()),
          f"linearize: a seeded mutation went uncaught: {caught}")
    if device.type == "cuda":
        check(counter.launches > 0, "K1 never launched in the sweep")
    return {"histories": {f"{b}@{cap},{ms}": n
                          for (b, cap, ms), n in counts.items()},
            "total": total, "violations": len(bad),
            "mutations_caught": caught, "ring_gather_launches":
                counter.launches, "wall_s": wall}


def checkers_paged(device, *, capacity: int = 16384, n_items: int = 131072,
                   batch: int = 1024, pops: int = 5000, seed: int = 0):
    """``PagedQueue`` past its ring: ``n_items`` distinct ids pushed in
    batches of ``batch`` into one int32 ring of ``capacity`` rows (pages of
    ``capacity // 2``), a quarter stolen, ``pops`` popped one by one with
    the low watermark an eighth below the top (refills, partial ones
    among them), the rest stolen; every id must come back exactly once, with the
    sanitizer's spill/refill audit armed and no violation.  The same
    pushes without the sanitizer give the plain time per push."""
    import torch
    from repro_torch.analysis import sanitize
    from repro_torch.core.ops import make_ops
    from repro_torch.core.queue import PagedQueue

    ids = np.random.default_rng(seed).permutation(n_items).astype(np.int32) + 1
    dev_ids = torch.from_numpy(ids).to(device)
    spec = torch.zeros((), dtype=torch.int32)
    sanitize.reset_violations()
    push_ms = {}
    for name, check_on in (("plain", False), ("check", True)):
        pq = PagedQueue(capacity, spec,
                        low_watermark=capacity - capacity // 8,
                        backend=make_ops("cuda", check=check_on),
                        device=device)
        check(pq._check == check_on, f"{name}: audit armed {pq._check}")
        sync(device)
        t0 = time.perf_counter()
        for at in range(0, n_items, batch):
            pq.push(dev_ids[at:at + batch], batch)
        sync(device)
        push_ms[name] = (time.perf_counter() - t0) * 1e3 / (n_items // batch)
        check(pq.total_size() == n_items, f"{name}: {pq.total_size()} held")
    stolen = pq.steal_bulk(0.25)
    popped = [pq.pop_item() for _ in range(pops)]
    check(None not in popped, "a pop found the queue empty")
    while pq.total_size() >= 2:
        stolen += pq.steal_bulk(1.0)
    while (item := pq.pop_item()) is not None:
        popped.append(item)
    back = np.sort(np.asarray(stolen + popped, np.int64))
    check(back.size == n_items and np.array_equal(back, np.sort(ids)),
          f"{back.size} ids came back for {n_items}, not each exactly once")
    check(sanitize.violations() == (),
          f"sanitizer violations: {sanitize.violations()[:3]}")
    check(pq.spills > 0 and pq.refills > 0,
          f"spills {pq.spills}, refills {pq.refills}")
    return {"capacity": capacity, "items": n_items, "batch": batch,
            "ring_multiple": n_items // capacity, "pops": len(popped),
            "stolen": len(stolen), "spills": pq.spills,
            "spilled_items": pq.spilled_items, "refills": pq.refills,
            "refilled_items": pq.refilled_items,
            "ms_per_push": push_ms["plain"],
            "ms_per_push_checked": push_ms["check"]}


def phase_checkers(device, counters, *, lanes: int, capacity: int,
                   backlog: int, max_steal: int, rounds: int,
                   geometries=((4, 2), (8, 4)), paged=None):
    """The relaxed backend and the three checkers on the card: (a) the
    backlog, (b) the model checker, (c) ``PagedQueue`` past its ring."""
    return {"backlog": checkers_backlog(
                device, counters, lanes=lanes, capacity=capacity,
                backlog=backlog, max_steal=max_steal, rounds=rounds),
            "linearize": checkers_linearize(
                device, counters["ring_gather"], geometries=geometries),
            "paged": checkers_paged(device, **(paged or {}))}


# ----------------------------------------------- phase 3: the DD solver


def _runtime_device(device, execution: str):
    """A runtime's ``device`` argument: the stacked lanes' device, or on a
    mesh each rank's own CUDA device (None) or the CPU."""
    if execution == "mesh" and device.type == "cuda":
        return None
    return device


def solve_counted(device, counters, cfg, execution: str, *,
                  profile: bool = False) -> dict:
    """``parallel_solve`` on the kernel routing, stacked or one lane per
    rank (every rank calls it), twice: this process's launch counters are
    zeroed just before the first run and read just after it, and the
    second run (warm: a mesh's communicators are up) is timed.  With
    ``profile``, a third run under the profiler
    (:func:`_profiled_solve`)."""
    from repro_torch.core.dd.knapsack import random_instance
    from repro_torch.core.dd.parallel import parallel_solve
    from repro_torch.core.policy import StealPolicy

    inst = random_instance(cfg["n_items"], seed=cfg["seed"])
    policy = StealPolicy(proportion=0.5, high_watermark=4, low_watermark=0,
                         max_steal=cfg["max_steal"])

    def solve():
        return parallel_solve(inst, n_workers=cfg["n_workers"],
                              explore_width=cfg["explore_width"],
                              batch=cfg["batch"], capacity=cfg["capacity"],
                              policy=policy, backend="cuda",
                              execution=execution,
                              device=_runtime_device(device, execution))

    for fn in counters.values():
        fn.launches = 0
    sync(device)
    t0 = time.perf_counter()
    opt, st = solve()
    sync(device)
    first = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(st["backend"] == "cuda", f"routing {st['backend']!r} is not cuda")
    t0 = time.perf_counter()
    _, warm = solve()
    sync(device)
    wall = time.perf_counter() - t0
    graph = [{k: s[f"graph_{k}"] for k in ("captures", "replays",
                                          "eager_blocks")}
             for s in (st, warm)]
    return dict(optimum=opt, supersteps=st["supersteps"],
                explored=st["explored"], transferred=st["transferred"],
                steals=st["telemetry"]["steals"],
                per_worker_explored=st["per_worker_explored"],
                launches=launches, wall_s_first=first, wall_s=wall,
                ms_per_superstep=wall * 1e3 / st["supersteps"],
                graph_blocks=graph,
                **(_profiled_solve(device, counters, solve) if profile
                   else {}))


def _profiled_solve(device, counters, solve) -> dict:
    """A third solve under the profiler (:func:`traced_launches`): how its
    blocks ran, each counter's launches and the profiler's count of each
    counter's kernel."""
    (_, st), counted, traced = traced_launches(device, counters, solve)
    return dict(profiled_blocks={k: st[f"graph_{k}"] for k in (
                    "captures", "replays", "eager_blocks")},
                launches_profiled=counted, kernels_profiled=traced)


def traced_launches(device, counters, fn):
    """``fn()`` under ``torch.profiler``: its result, each counter's
    launches in the call, and each counter's kernel
    (:data:`COUNTED_KERNELS`) counted in the profiler's device events,
    which list every kernel a CUDA graph's replay runs."""
    import torch
    from torch.autograd import DeviceType

    before = {name: c.launches for name, c in counters.items()}
    sync(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(device)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    counted = {name: c.launches - before[name]
               for name, c in counters.items()}
    traced = {name: sum(bool(re.search(rf"\b{COUNTED_KERNELS[name]}\b",
                                       n)) for n in names)
              for name in counters}
    return out, counted, traced


def phase_solver(device, counters, *, n_items: int, seed: int,
                 n_workers: int, explore_width: int, batch: int,
                 capacity: int, max_steal: int, expect=None, off_path=None):
    """The solver on the kernel routing; the launch counters of the path's
    kernels (``counters``: each must launch) and of ``off_path`` (none may)
    are zeroed just before the run and read just after it."""
    from repro_torch.core.dd.knapsack import dp_solve, random_instance

    off_path = off_path or {}
    out = solve_counted(device, {**counters, **off_path}, dict(
        n_items=n_items, seed=seed, n_workers=n_workers,
        explore_width=explore_width, batch=batch, capacity=capacity,
        max_steal=max_steal), "vmap", profile=device.type == "cuda")
    launches = {name: out["launches"][name] for name in counters}
    off = {name: out["launches"][name] for name in off_path}
    got = {k: out[k] for k in ("optimum", "supersteps", "explored",
                               "transferred", "steals")}
    check(got["optimum"] == dp_solve(random_instance(n_items, seed=seed)),
          f"optimum {got['optimum']} != dp_solve")
    if expect is not None:
        check(got == expect, f"solver results {got} != {expect}")
    if device.type == "cuda":
        for name, n in launches.items():
            check(n > 0, f"{name} never launched on the solver path")
        # the timed solve: every block a replay of the captured graph
        timed = out["graph_blocks"][1]
        check(timed["replays"] > 0 and timed["eager_blocks"] == 0,
              f"the second solve's blocks ran {timed}, not all replayed")
        # the third solve, under the profiler, replayed too: each counter
        # equals the launches of its kernel that the card ran
        blocks = out["profiled_blocks"]
        check(blocks["replays"] > 0 and blocks["eager_blocks"] == 0,
              f"the profiled solve's blocks ran {blocks}, not all replayed")
        counted, traced = out["launches_profiled"], out["kernels_profiled"]
        check(counted == traced and all(counted[n] > 0 for n in counters),
              f"launch counters {counted} != the profiler's kernels "
              f"{traced}")
    for name, n in off.items():
        check(n == 0, f"{name} launched {n} times on the solver path")
    return {**got, "launches": launches, "launches_off_path": off,
            **{k: out.get(k) for k in (
                "wall_s_first", "wall_s", "ms_per_superstep",
                "graph_blocks", "profiled_blocks", "launches_profiled",
                "kernels_profiled")}}


def phase_sequential(device, counter, *, n_items: int, seed: int,
                     width: int, batch: int, expect=None):
    """Phase 3b: the sequential solver (``bnb.solve``), one launch of the
    fused explore (``counter``) per step; the JAX package's results."""
    from repro_torch.core.dd.bnb import solve
    from repro_torch.core.dd.knapsack import dp_solve, random_instance

    inst = random_instance(n_items, seed=seed)
    counter.launches = 0
    sync(device)
    t0 = time.perf_counter()
    opt, st = solve(inst, width=width, batch=batch, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    launches = counter.launches
    got = dict(optimum=opt, **st)
    check(opt == dp_solve(inst), f"sequential optimum {opt} != dp_solve")
    if expect is not None:
        check(got == expect, f"sequential solver {got} != {expect}")
    if device.type == "cuda":
        check(launches == st["supersteps"],
              f"the fused explore launched {launches} times in "
              f"{st['supersteps']} steps, not once per step")
    return {**got, "launches": launches, "wall_s": wall,
            "ms_per_step": wall * 1e3 / st["supersteps"]}


# -------------------------------------------- phase 8: resilience


def dag_body(ops, *, n_nodes: int, pop: int, fanout: int):
    """The Fig. 9 DAG's worker body on the stacked lanes (the JAX
    package's ``tests/test_resilience.py`` body): pop up to ``pop`` nodes
    a lane (one K3 launch), push their children below ``n_nodes`` (one
    K2 launch); the carry counts the nodes each lane explored."""
    import torch

    def body(q, carry):
        q, nodes, n_popped = ops.pop_bulk(q, pop, pop, donate=True)
        w, dev = q.size.shape[0], q.size.device
        valid = (torch.arange(pop, dtype=torch.int32, device=dev)[None, :]
                 < n_popped[:, None])
        kids = (nodes[:, :, None] * fanout + 1
                + torch.arange(fanout, dtype=torch.int32, device=dev))
        live = valid[:, :, None] & (kids < n_nodes)
        flat, flive = kids.reshape(w, -1), live.reshape(w, -1)
        order = torch.argsort((~flive).to(torch.int32), dim=1, stable=True)
        flat = torch.where(flive.gather(1, order), flat.gather(1, order), 0)
        q, _ = ops.push(q, flat, flive.sum(1).to(torch.int32), donate=True)
        return q, carry + valid.sum(1).to(torch.int32)
    return body


def _digest(a) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _dag_runtime(device, cfg, plan, pod_size=None, seed_root=True):
    import torch
    from repro_torch.core.policy import StealPolicy
    from repro_torch.runtime import FaultPlan, StealRuntime

    rt = StealRuntime(cfg["lanes"], cfg["capacity"],
                      torch.zeros((), dtype=torch.int32),
                      policy=StealPolicy(backend="cuda",
                                         max_steal=cfg["max_steal"],
                                         **cfg["policy"]),
                      pod_size=pod_size, device=device,
                      fault_plan=None if plan is None else FaultPlan(**plan))
    if seed_root:
        rt.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    return rt


def _drain(rt, body, carry, block: int):
    """``run_fused(block, until_drained=True)`` blocks to the drain:
    ``(carry, rounds run, rounds dispatched)``."""
    rounds = dispatched = 0
    while rt.total_size() > 0 and rounds < 10_000:
        carry, _, r = rt.run_fused(block, body, carry, until_drained=True)
        rounds, dispatched = rounds + r, dispatched + block
    return carry, rounds, dispatched


def _live_items(rt) -> np.ndarray:
    """Every live item of every lane, sorted (the multiset)."""
    from repro_torch.core.ops import queue_to_numpy
    q = queue_to_numpy(rt.queues)
    cap = q.buf.shape[1]
    return np.sort(np.concatenate(
        [q.buf[w][(q.lo[w] + np.arange(q.size[w])) % cap]
         for w in range(len(q.lo))]))


def _pins(rt, carry, rounds) -> dict:
    """What scripts/resilience_pins.py reports for the JAX package."""
    from repro_torch.core.ops import queue_to_numpy
    q = queue_to_numpy(rt.queues)
    return {"rounds": rounds, "summary": rt.telemetry.summary(),
            "carry": carry.cpu().tolist(), "sizes": q.size.tolist(),
            "history": _digest(np.asarray(rt.controller.history,
                                          np.float32)),
            "history_len": len(rt.controller.history),
            "rings": _digest(q.buf), "lo": _digest(q.lo)}


RESILIENCE_KERNELS = ("ring_gather", "ring_transfer", "ring_slice",
                      "ring_scatter")


def _replay(device, counters, cfg, plan, pod_size, probe: bool = False):
    """One drain of the DAG from lane 0's root, the path's launch counters
    zeroed just before it and read just after it (``probe``: with a phase
    probe attached, phase 14)."""
    import torch
    rt = _dag_runtime(device, cfg, plan, pod_size)
    if probe:
        rt.attach_phase_probe()
    body = dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                    fanout=cfg["fanout"])
    for name in RESILIENCE_KERNELS:
        counters[name].launches = 0
    sync(device)
    t0 = time.perf_counter()
    carry, rounds, dispatched = _drain(
        rt, body, torch.zeros((cfg["lanes"],), dtype=torch.int32,
                              device=device), cfg["block"])
    sync(device)
    wall = time.perf_counter() - t0
    launches = {name: counters[name].launches for name in RESILIENCE_KERNELS}
    check(int(carry.sum()) == cfg["n_nodes"],
          f"{int(carry.sum())} nodes explored, not {cfg['n_nodes']} once each")
    check((rt.sizes()[rt.dead_lanes()] == 0).all(), "a dead lane holds work")
    return rt, carry, rounds, dispatched, launches, wall


def phase_resilience(device, counters, cfg, expect=None, turns: int = 3):
    """Phase 8: fault replays, snapshots and elastic resize on the card
    (see the module docstring)."""
    import tempfile

    import torch
    from repro_torch.distributed import elastic
    from repro_torch.launch.resilient import run_resilient
    from repro_torch.runtime import FaultPlan
    from repro_torch.train import checkpoint

    t_phase = time.perf_counter()
    out = {}
    # (a) flat and (b) hierarchical replays, against the JAX package's
    # pins, with the kernels' launches per dispatched round: K3 and K2
    # once a worker body, K1 and K4 once a superstep (normal and recovery
    # flat; intra and cross-pod, each twice, in pods).
    for name, plan, pod, per in (
            ("flat", cfg["flat_plan"], None, 2),
            ("hier", cfg["hier_plan"], cfg["pod_size"], 4)):
        rt, carry, rounds, dispatched, launches, wall = _replay(
            device, counters, cfg, plan, pod)
        got = _pins(rt, carry, rounds)
        if expect is not None:
            check(got == expect[name],
                  f"resilience {name}: {got} != {expect[name]}")
        if device.type == "cuda":
            want_l = {"ring_gather": per * dispatched,
                      "ring_transfer": per * dispatched,
                      "ring_slice": dispatched, "ring_scatter": dispatched}
            check(launches == want_l,
                  f"resilience {name}: launches {launches} != {want_l}")
        out[name] = {**got, "dispatched": dispatched, "launches": launches,
                     "dead": int(rt.dead_lanes().sum())}
        if name == "flat":
            flat_rt, flat = rt, got

    # The fault layer's cost: the unarmed flat runtime, the armed flat and
    # the armed hierarchical one, drained in turns.
    ms = {"unarmed": [], "flat": [], "hier": []}
    for _ in range(turns):
        for key, plan, pod in (("unarmed", None, None),
                               ("flat", cfg["flat_plan"], None),
                               ("hier", cfg["hier_plan"], cfg["pod_size"])):
            rt, _, rounds, dispatched, launches, wall = _replay(
                device, counters, cfg, plan, pod)
            if key == "unarmed" and device.type == "cuda":
                check(launches["ring_gather"] == dispatched
                      and launches["ring_transfer"] == dispatched,
                      f"unarmed launches {launches} in {dispatched} rounds")
            ms[key].append(wall * 1e3 / rounds)
    out["ms_per_round"] = ms

    with tempfile.TemporaryDirectory() as tmp:
        # (c) run_resilient crashes at round 6 (blocks of 2 rounds,
        # snapshots every 4), restarts from the snapshot of round 4 and
        # lands on (a)'s rings, cursors and round count.
        snap = str(Path(tmp) / "crash")
        crashed, final = [], {}

        def make_runtime():
            return _dag_runtime(device, cfg, cfg["flat_plan"],
                                seed_root=checkpoint.latest_step(snap)
                                is None)

        def drive(rt, should_stop):
            body = dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                            fanout=cfg["fanout"])
            carry = torch.zeros((cfg["lanes"],), dtype=torch.int32,
                                device=device)
            while rt.total_size() > 0 and not should_stop():
                if not crashed and rt.rounds_run >= 6:
                    crashed.append(rt.rounds_run)
                    raise RuntimeError("simulated crash at round 6")
                carry, _, _ = rt.run_fused(2, body, carry,
                                           until_drained=True)
            final.update(rt=rt, carry=carry)
            return rt.rounds_run

        # One restart is allowed, and it must be the simulated crash's: any
        # other exception ends the phase (a second one propagates out of
        # the supervisor).  The supervisor prints the caught traceback.
        caught = []
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rounds = run_resilient(
                make_runtime, drive, snapshot_dir=snap, snapshot_every=4,
                max_restarts=1, on_restart=lambda _, e: caught.append(e))
        check(len(caught) == 1 and str(caught[0]) == "simulated crash at "
              "round 6" and err.getvalue().count("Traceback") == 1,
              f"run_resilient caught {caught!r}, stderr:\n{err.getvalue()}")
        resumed = _pins(final["rt"], final["carry"], rounds)
        check(crashed == [6] and rounds == flat["rounds"]
              and resumed["rings"] == flat["rings"]
              and resumed["lo"] == flat["lo"]
              and resumed["sizes"] == flat["sizes"],
              f"crash-resume {resumed} != the uninterrupted run")
        restarts = final["rt"].telemetry.fault_events.get("restart", 0)
        check(restarts == 1, f"{restarts} restarts recorded, not 1")

        # A flat snapshot of round 8 restores into a fresh hierarchical
        # runtime, which finishes the drain with the exact multiset.
        rt = _dag_runtime(device, cfg, cfg["flat_plan"])
        body = dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                        fanout=cfg["fanout"])
        carry, _ = rt.run_fused(8, body, torch.zeros(
            (cfg["lanes"],), dtype=torch.int32, device=device))
        before = _live_items(rt)
        rt.save_state(str(Path(tmp) / "flat"))
        hier = _dag_runtime(device, cfg, {}, cfg["pod_size"],
                            seed_root=False)
        check(hier.restore_state(str(Path(tmp) / "flat")) == 8,
              "the flat snapshot did not restore at round 8")
        check(np.array_equal(_live_items(hier), before)
              and np.array_equal(hier.fault.kill_round, rt.fault.kill_round),
              "the flat snapshot restored another state")
        carry, rounds_h, _ = _drain(hier, body, carry, cfg["block"])
        check(int(carry.sum()) == cfg["n_nodes"]
              and hier.total_size() == 0,
              "the hierarchical runtime did not finish the flat drain")
    out["snapshots"] = {"crash_at": crashed[0], "resumed_rounds": rounds,
                        "restarts": restarts, "flat_to_hier_items":
                        int(before.size), "hier_rounds": rounds_h}

    # (d) elastic: shrink 64 -> 56 and grow back, and a live resize of a
    # padded runtime, each keeping the exact multiset; the live resize
    # builds and captures nothing.
    lanes = cfg["lanes"]
    rt = _dag_runtime(device, cfg, {})
    body = dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                    fanout=cfg["fanout"])
    rt.run_fused(8, body, torch.zeros((lanes,), dtype=torch.int32,
                                      device=device))
    before = _live_items(rt)
    small = elastic.shrink(rt, range(lanes - lanes // 8, lanes))
    check(small.n_workers == lanes - lanes // 8
          and np.array_equal(_live_items(small), before),
          "shrink lost or duplicated items")
    big = elastic.grow(small, lanes // 8)
    check(big.n_workers == lanes and np.array_equal(_live_items(big), before),
          "grow lost or duplicated items")
    pad = elastic.padded_runtime(
        lanes * 3 // 4, cfg["capacity"], torch.zeros((), dtype=torch.int32),
        w_max=lanes, policy=rt.policy, device=device)
    pad.push(0, torch.zeros((1,), dtype=torch.int32), 1)
    pad.run_fused(8, body, torch.zeros((lanes,), dtype=torch.int32,
                                       device=device))
    before_pad = _live_items(pad)
    c0 = elastic.compile_count(pad)
    grown = elastic.live_grow(pad, lanes // 4)
    pad.run_fused(4)
    evac = elastic.live_shrink(pad, range(lanes // 8))
    pad.run_fused(4)
    check(np.array_equal(_live_items(pad), before_pad),
          "the live resize lost or duplicated items")
    check(elastic.compile_count(pad) == c0,
          "the live resize built or captured something")
    out["elastic"] = {"items": int(before.size), "shrunk_to": small.n_workers,
                      "grown_to": big.n_workers,
                      "padded_items": int(before_pad.size),
                      "live_grown": len(grown), "evacuation_rounds": evac,
                      "live": elastic.n_live(pad), "compile_count": c0}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------- phase 9: one lane per process


def _rank_device(rank: int, device_type: str):
    import torch
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _transport(rt) -> str:
    import torch.distributed as dist
    if rt.lanes.stacked:
        return "stacked"
    where = "staged through the host" if rt.lanes.staged else "on the device"
    return f"{dist.get_backend(rt.lanes.group)}, {where}"


def _run_digests(rt) -> dict:
    """SHA-256 digests of the W lanes' rings, ``lo``, sizes and telemetry
    records."""
    from repro_torch.core.ops import queue_to_numpy
    q = queue_to_numpy(rt.gathered_queues())
    records = json.dumps([dataclasses.astuple(r)
                          for r in rt.telemetry.rounds]).encode()
    return {"rings": _digest(np.concatenate(
                [q.buf[k].reshape(-1) for k in sorted(q.buf)])),
            "lo": _digest(q.lo), "sizes": _digest(q.size),
            "telemetry": hashlib.sha256(records).hexdigest()[:16]}


def mesh_backlog(device, cfg, execution: str) -> dict:
    """Phase 2's backlog at ``cfg``'s size through ``rounds`` supersteps,
    compact and dense, flat and in pods; each configuration runs twice
    and the second run is timed."""
    items = backlog_items(cfg["lanes"], cfg["backlog"], seed=0)
    out = {}
    for pod_size in (None, cfg["pod_size"]):
        for exchange in ("compact", "dense"):
            for _ in range(2):  # the first run warms up
                rt = backlog_runtime(device, items, backend="cuda",
                                     exchange=exchange, lanes=cfg["lanes"],
                                     capacity=cfg["capacity"],
                                     max_steal=cfg["max_steal"],
                                     execution=execution, pod_size=pod_size)
                sync(device)
                t0 = time.perf_counter()
                rt.run_fused(cfg["rounds"])
                sync(device)
                wall = time.perf_counter() - t0
            out[f"{'pods' if pod_size else 'flat'}/{exchange}"] = dict(
                _run_digests(rt), moved=rt.telemetry.total_transferred,
                ms_per_superstep=wall * 1e3 / cfg["rounds"],
                transport=_transport(rt))
    return out


def _mesh_rank(rank: int, cfg: dict, device_type: str) -> dict:
    """One rank of phase 9 (a), (b) and its decode check."""
    _, counters = _port()
    device = _rank_device(rank, device_type)
    return {"solver": solve_counted(device, counters, cfg["solver"],
                                    "mesh"),
            "backlog": mesh_backlog(device, cfg["backlog"], "mesh"),
            "decode": mesh_decode(device, PHASE9_DECODE,
                                  cfg["solver"]["n_workers"], "mesh")}


def _single_rank(rank: int, cfg: dict, device_type: str) -> dict:
    """Phase 9 (c): the solver on a mesh of one rank."""
    _, counters = _port()
    return solve_counted(_rank_device(rank, device_type), counters,
                       cfg["single"], "mesh")


SOLVER_PINS = ("optimum", "supersteps", "explored", "transferred", "steals",
               "per_worker_explored")


def phase_mesh(device, counters, cfg, expect=None) -> dict:
    """Phase 9: (a) the solver and (b) the backlog on one lane per gloo
    rank, each held to the stacked runtime's run in this process (and (a)
    to ``expect``); every rank's launch counters, read by the rank itself;
    (c) the solver on one rank under ``cfg["single_backend"]``."""
    from repro_torch.core.dd.knapsack import dp_solve, random_instance
    from repro_torch.launch.mesh import run_workers

    n = cfg["solver"]["n_workers"]
    t0 = time.perf_counter()
    ranks = run_workers(functools.partial(_mesh_rank, cfg=cfg,
                                          device_type=device.type),
                        n, backend="gloo", timeout=cfg["timeout"])
    wall = time.perf_counter() - t0

    # (a) the solver: every rank's result, the stacked run's, the pins
    pins = lambda r: {k: r[k] for k in SOLVER_PINS}  # noqa: E731
    got = pins(ranks[0]["solver"])
    for r, res in enumerate(ranks):
        check(pins(res["solver"]) == got, f"rank {r}'s solver results "
              f"{pins(res['solver'])} differ from rank 0's {got}")
    stacked = solve_counted(device, counters, cfg["solver"], "vmap")
    check(pins(stacked) == got,
          f"mesh solver {got} != stacked {pins(stacked)}")
    inst = random_instance(cfg["solver"]["n_items"],
                           seed=cfg["solver"]["seed"])
    check(got["optimum"] == dp_solve(inst), "mesh optimum != dp_solve")
    if expect is not None:
        check(got == expect, f"mesh solver {got} != {expect}")
    # run() drives blocks of 8 rounds until one drains early: every round
    # of every block launches the body's K3, fused explore and K2 push
    # and the superstep's K1 window and K4 splice, on each rank's lane
    s = got["supersteps"]
    dispatched = 8 * (s // 8 + 1)
    launches = [res["solver"]["launches"] for res in ranks]
    if device.type == "cuda":
        for r, lr in enumerate(launches):
            want = {"dd_expand": dispatched, "ring_slice": dispatched,
                    "ring_gather": dispatched, "ring_transfer": dispatched,
                    "ring_scatter": dispatched + (r == 0)}  # + seed push
            check(lr == want, f"rank {r} launched {lr}, not {want} in "
                  f"{dispatched} dispatched rounds")

    # (b) the backlog: digests equal to the stacked runtime's
    backlog = mesh_backlog(device, cfg["backlog"], "vmap")
    keys = ("rings", "lo", "sizes", "telemetry", "moved")
    for name, want in backlog.items():
        for r, res in enumerate(ranks):
            mine = res["backlog"][name]
            check({k: mine[k] for k in keys} == {k: want[k] for k in keys},
                  f"backlog {name}: rank {r}'s {mine} != stacked {want}")
        check(want["moved"] > 0, f"backlog {name} moved nothing")

    # the decode check: every rank's runs equal the stacked run's
    decode = mesh_decode(device, PHASE9_DECODE, n, "vmap")
    for name, want in decode.items():
        for r, res in enumerate(ranks):
            mine = {k: v for k, v in res["decode"][name].items()
                    if k != "ms_per_round"}
            check(mine == {k: v for k, v in want.items()
                           if k != "ms_per_round"},
                  f"decode {name}: rank {r}'s run differs from the stacked "
                  f"run's")
    check(decode["balanced"]["stolen"] > 0, "mesh decode stole nothing")
    check(decode["migrate"]["migrated"] > 0, "mesh decode migrated nothing")

    # (c) one rank under cfg["single_backend"]
    t1 = time.perf_counter()
    [single] = run_workers(functools.partial(_single_rank, cfg=cfg,
                                             device_type=device.type),
                           1, backend=cfg["single_backend"],
                           timeout=cfg["timeout"])
    single_wall = time.perf_counter() - t1
    single_stacked = solve_counted(device, counters, cfg["single"], "vmap")
    check(pins(single) == pins(single_stacked),
          f"{cfg['single_backend']} mesh of one {pins(single)} != stacked "
          f"{pins(single_stacked)}")

    return {
        "ranks": n, "cut": f"{n} lanes, one per rank on one card, where "
        f"phase 3 stacks {LANES}",
        "solver": {**got, "ms_per_superstep": {
            "mesh": ranks[0]["solver"]["ms_per_superstep"],
            "stacked": stacked["ms_per_superstep"]},
            "launches_per_rank": launches, "dispatched_rounds": dispatched},
        "backlog": {name: {
            "digests": {k: want[k] for k in keys[:4]}, "moved": want["moved"],
            "ms_per_superstep": {"mesh": ranks[0]["backlog"][name][
                "ms_per_superstep"], "stacked": want["ms_per_superstep"]},
            "transport": ranks[0]["backlog"][name]["transport"]}
            for name, want in backlog.items()},
        "single": {**pins(single), "backend": cfg["single_backend"],
                   "ms_per_superstep": {
                       "mesh": single["ms_per_superstep"],
                       "stacked": single_stacked["ms_per_superstep"]},
                   "wall_s_first": single["wall_s_first"],
                   "wall_s": single_wall},
        "decode": {name: {**{k: want[k] for k in ("rounds", "stolen",
                                                   "migrated", "stalls",
                                                   "stamps")},
                          "ms_per_round": {
                              "mesh": ranks[0]["decode"][name]["ms_per_round"],
                              "stacked": want["ms_per_round"]}}
                   for name, want in decode.items()},
        "wall_s": wall}


# ------------------------------------------------ phases 4-6: serving


def _serve_routes():
    """The serving path's kernels: the module attribute through which the
    models reach each wrapper (so one comparison can swap in the plain
    version; the package has no switch) and that plain version."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    return {"flash_attention": (flash_ops, "mha", attention_ref),
            "ssd_scan": (ssd_ops, "ssd", ssd_chunked)}


@contextlib.contextmanager
def _plain(names):
    """The kernels ``names`` swapped for their plain versions where the
    models reach them (the package has no switch)."""
    routes = _serve_routes()
    kernels = {n: getattr(routes[n][0], routes[n][1]) for n in names}
    for n in names:
        setattr(routes[n][0], routes[n][1], routes[n][2])
    try:
        yield
    finally:
        for n in names:
            setattr(routes[n][0], routes[n][1], kernels[n])


def serve_launches(cfg) -> dict:
    """Launches of each kernel per prefill wave on ``cfg``'s path: K6 once
    per attention layer (per shared-block application in the hybrid), K7
    once per Mamba2 block."""
    if cfg.family == "ssm":
        return {"ssd_scan": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "ssd_scan": cfg.n_layers}
    if cfg.family == "encdec":  # encoder; decoder self and cross
        return {"flash_attention": cfg.n_encoder_layers + 2 * cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


class _Clocked:
    """Wraps a model's ``prefill`` and ``decode_step``: the wall time of
    each call, synchronised with the device, each prefill's token shape,
    each decode step's batch, and the first prefill's tokens and logits.
    ``restore()`` unwraps."""

    def __init__(self, model, device):
        self.model, self.device = model, device
        self.prefill_ms, self.decode_ms, self.first = [], [], None
        self.prefill_shapes, self.decode_batch = [], []
        self._prefill, self._decode = model.prefill, model.decode_step
        model.prefill, model.decode_step = self.prefill, self.decode

    def _timed(self, fn, times, *args):
        sync(self.device)
        t = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        times.append((time.perf_counter() - t) * 1e3)
        return out

    def prefill(self, params, tokens):
        self.prefill_shapes.append(list(tokens.shape))
        logits, cache = self._timed(self._prefill, self.prefill_ms, params,
                                    tokens)
        if self.first is None:
            self.first = (tokens.clone(), logits.clone())
        return logits, cache

    def decode(self, params, cache, tokens):
        self.decode_batch.append(tokens.shape[0])
        return self._timed(self._decode, self.decode_ms, params, cache,
                           tokens)

    def restore(self):
        self.model.prefill, self.model.decode_step = (self._prefill,
                                                      self._decode)


def _init_model(cfg, device, seed):
    import torch
    from repro_torch.models.zoo import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    sync(device)
    return model, params, time.perf_counter() - t0


def _prompts(rng, cfg, n: int, prompt_lens):
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, int(m))]
            for m in lens]


def _run_counted(device, names, fn):
    """``fn()`` with the launch counters of the kernels ``names`` zeroed
    just before it and read just after it; returns (result, wall s,
    launches, launches on a tensor-core route for the kernels that have
    one)."""
    routes = _serve_routes()
    wrappers = {n: getattr(routes[n][0], routes[n][1]) for n in names}
    tensor_core = {n: w for n, w in wrappers.items()
                   if hasattr(w, "launches_tc")}
    for w in wrappers.values():
        w.launches = 0
    for w in tensor_core.values():
        w.launches_tc = 0
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    wall = time.perf_counter() - t0
    return (out, wall, {n: w.launches for n, w in wrappers.items()},
            {n: w.launches_tc for n, w in tensor_core.items()})


def _check_launches(device, cfg, expect, launches, launches_tc,
                    waves: int) -> None:
    """Each kernel launched ``expect`` times per prefill wave; in bfloat16
    compute, every launch of a kernel with a tensor-core route on it."""
    if device.type != "cuda":
        return
    for name, per_wave in expect.items():
        check(launches[name] == per_wave * waves,
              f"{name} launched {launches[name]} times for {waves} "
              f"prefill waves, not {per_wave} per wave")
    if cfg.compute_dtype == "bfloat16":
        for name, n in launches_tc.items():
            check(n == launches[name],
                  f"{name}: {n} of {launches[name]} bfloat16 launches on "
                  f"the tensor-core route")


def phase_serve(device, *, cfg, n_requests: int, prompt_lens,
                max_new: int, max_seq: int, wave_size: int,
                slow_speed: float, seed: int = 0,
                first_wave=None, poll=None):
    """The wave engine behind the admission master, with the launch
    counters of the path's kernels zeroed just before the run and read
    just after it; then the first wave's prefill once more with the plain
    versions swapped in, to compare logits (``first_wave``, default
    :func:`first_wave_check`).  ``poll(cluster)``, if given, runs once
    after the drain (phase 14 reads the cluster's metrics there)."""
    from repro_torch.core.policy import StealPolicy
    from repro_torch.serve.engine import Replica, ServeCluster
    from repro_torch.serve.scheduler import AdmissionMaster, Request

    expect = serve_launches(cfg)
    model, params, init_s = _init_model(cfg, device, seed)
    clock = _Clocked(model, device)
    reps = [Replica(model, params, wave_size=wave_size, max_seq=max_seq)
            for _ in range(2)]
    reps[0].speed = slow_speed
    master = AdmissionMaster(2, StealPolicy(proportion=0.5, low_watermark=1,
                                            high_watermark=2))
    cluster = ServeCluster(reps, master)
    prompts = _prompts(np.random.default_rng(seed), cfg, n_requests,
                       prompt_lens)
    reqs = [Request(prompt=p, max_new=max_new) for p in prompts]

    def serve():
        cluster.submit(reqs)
        return cluster.run_until_drained()

    done, wall, launches, launches_tc = _run_counted(device, expect, serve)
    clock.restore()
    if poll is not None:
        poll(cluster)

    st = master.stats()
    tokens = sum(len(r.output or []) for r in done)
    check(len(done) == n_requests, f"served {len(done)} of {n_requests}")
    check(all(len(r.output) == max_new for r in done),
          f"a request got fewer than {max_new} tokens")
    check(sum(st["completed"]) == n_requests,
          f"master completed {st['completed']}")
    check(st["stolen"] > 0, "the master never stole")
    prefill_ms, decode_ms = clock.prefill_ms, clock.decode_ms
    _check_launches(device, cfg, expect, launches, launches_tc,
                    len(prefill_ms))

    tokens0, logits0 = clock.first
    first_wave = (first_wave or first_wave_check)(cfg, params, tokens0,
                                                  logits0, expect)
    decode_total = sum(decode_ms)
    by_batch = {}
    for b, ms in zip(clock.decode_batch, decode_ms):
        by_batch.setdefault(b, []).append(ms)
    return {
        "arch": cfg.name, "params": cfg.param_count(), "init_s": init_s,
        "requests": len(done), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefill_waves": len(prefill_ms),
        "prefill_ms": prefill_ms, "prefill_shapes": clock.prefill_shapes,
        "prefill_ms_mean": sum(prefill_ms) / len(prefill_ms),
        "prefill_share": sum(prefill_ms) / (wall * 1e3),
        "decode_steps": len(decode_ms),
        "decode_ms_per_step": decode_total / len(decode_ms),
        # batch -> [steps, mean ms]: a step's time depends on its batch,
        # and the waves' make-up on the straggler monitor's wall clock
        "decode_ms_by_batch": {b: [len(v), sum(v) / len(v)]
                               for b, v in sorted(by_batch.items())},
        "decode_ms_per_token": decode_total / tokens,
        "prompt_tokens": sum(map(len, prompts)),
        "first_wave_shape": list(tokens0.shape), **first_wave,
        "stolen": st["stolen"], "rounds": st["rounds"],
        "completed": st["completed"], "launches": launches,
        "launches_tensor_core": launches_tc}


def phase_wave(device, *, cfg, n_prompts: int, prompt_lens, max_new: int,
               max_seq: int, seed: int = 0):
    """One ``Replica.run_wave`` of ``n_prompts`` prompts, with the path's
    launch counters zeroed just before it and read just after it; then
    the same first-wave comparison as :func:`phase_serve`."""
    from repro_torch.serve.engine import Replica
    from repro_torch.serve.scheduler import Request

    expect = serve_launches(cfg)
    model, params, init_s = _init_model(cfg, device, seed)
    clock = _Clocked(model, device)
    prompts = _prompts(np.random.default_rng(seed), cfg, n_prompts,
                       prompt_lens)
    wave = [Request(prompt=p, max_new=max_new) for p in prompts]
    replica = Replica(model, params, wave_size=n_prompts, max_seq=max_seq)
    done, wall, launches, launches_tc = _run_counted(
        device, expect, lambda: replica.run_wave(wave))
    clock.restore()

    check(len(done) == n_prompts and all(len(r.output) == max_new
                                         for r in done),
          f"a request got fewer than {max_new} tokens")
    _check_launches(device, cfg, expect, launches, launches_tc,
                    len(clock.prefill_ms))
    tokens0, logits0 = clock.first
    first_wave = first_wave_check(cfg, params, tokens0, logits0, expect)
    tokens = sum(len(r.output) for r in done)
    decode_total = sum(clock.decode_ms)
    return {
        "arch": cfg.name, "params": cfg.param_count(), "init_s": init_s,
        "requests": len(done), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefill_ms": clock.prefill_ms,
        "decode_steps": len(clock.decode_ms),
        "decode_ms_per_step": decode_total / len(clock.decode_ms),
        "decode_ms_per_token": decode_total / tokens,
        "prompt_tokens": sum(map(len, prompts)),
        "first_wave_shape": list(tokens0.shape), **first_wave,
        "launches": launches, "launches_tensor_core": launches_tc}


def first_wave_check(cfg, params, tokens, logits_kernel, names):
    """The first wave's last-position prefill logits through the kernels
    ``names`` against the same prefill with their plain versions swapped
    in together, in the run's bfloat16 compute and in float32 compute."""
    import dataclasses
    from repro_torch.models.zoo import build_model

    bf16, f32 = build_model(cfg), build_model(
        dataclasses.replace(cfg, compute_dtype="float32"))
    out = {}
    with _plain(names):
        out["bf16/plain"] = bf16.prefill(params, tokens)[0]
        out["f32/plain"] = f32.prefill(params, tokens)[0]
    out["f32/kernel"] = f32.prefill(params, tokens)[0]
    f32_err = _close(out["f32/kernel"], out["f32/plain"], SERVE_TOL_F32,
                     f"first wave, float32 compute: {'+'.join(names)} vs "
                     f"plain")
    kern, plain, ref = logits_kernel.double(), out["bf16/plain"].double(), \
        out["f32/plain"].double()
    dev_kernel = float((kern - ref).abs().mean())
    dev_plain = float((plain - ref).abs().mean())
    check(dev_kernel <= SERVE_BF16_RATIO * dev_plain,
          f"first wave, bfloat16 compute: the kernels' logits sit "
          f"{dev_kernel} from the float32 ones on average, the plain "
          f"versions' {dev_plain}")
    diff = (kern - plain).abs()
    return {
        "first_wave_f32_max_abs_err": f32_err,
        "first_wave_bf16_max_abs_err": float(diff.max()),
        "first_wave_bf16_outside_2e-2": float(
            (diff > SERVE_TOL_BF16 * (1 + plain.abs())).double().mean()),
        "first_wave_bf16_mean_dev_from_f32": {"kernel": dev_kernel,
                                              "plain": dev_plain},
        "first_wave_greedy_agreement": float(
            (kern.argmax(-1) == plain.argmax(-1)).double().mean())}


# ------------------------------------- phase 10: continuous-batching decode


DECODE_KERNELS = ("ring_gather", "ring_scatter", "ring_slice",
                  "ring_transfer")


def decode_mix(n: int, seed: int, max_prompt: int, max_new: int) -> list:
    """benchmarks/serve_decode.py's _request_mix at ``max_prompt`` /
    ``max_new``: prompt lengths uniform in 1..max_prompt, outputs
    ``min(1 + geometric(0.35), max_new)``, tokens in 1..499."""
    rng = np.random.default_rng(seed)
    mix = []
    for _ in range(n):
        plen = int(rng.integers(1, max_prompt + 1))
        out = int(min(1 + rng.geometric(0.35), max_new))
        mix.append(([int(t) for t in rng.integers(1, 500, size=plen)], out))
    return mix


def decode_requests(request_cls, cfg) -> list:
    """The phase's requests as ``request_cls`` objects, rid = index."""
    pol = cfg["policy"]
    return [request_cls(prompt=p, max_new=m, rid=i) for i, (p, m) in
            enumerate(decode_mix(cfg["n_requests"], cfg["seed"],
                                 pol["max_prompt"], pol["max_new"]))]


def drive_decode(cluster, reqs, arrival: int) -> None:
    """serve_decode.py's _drain: ``arrival`` requests, one step, and so on,
    then drain.  Works on either package's DecodeCluster."""
    cluster.submit(reqs[:arrival])
    cluster.step()
    i = arrival
    while i < len(reqs):
        cluster.submit(reqs[i:i + arrival])
        i += arrival
        cluster.step()
    cluster.run_until_drained(max_steps=5000)


def decode_integers(cluster) -> dict:
    """The scheduling integers of a drained DecodeCluster (either
    package's): rounds, items stolen, migrations, stalls and a digest of
    every request's (rid, admit, first, finish)."""
    stamps = sorted([int(r.rid), int(r.admit), int(r.first), int(r.finish)]
                    for r in cluster.telemetry.requests)
    return dict(rounds=int(cluster.rounds), stolen=int(cluster.stolen),
                migrated=int(cluster.migrated),
                stalls=int(cluster.stats()["stalls"]),
                stamps=hashlib.sha256(json.dumps(stamps).encode()
                                      ).hexdigest()[:16])


def _decode_model(cfg, device):
    from repro_torch import configs
    mcfg = configs.get(cfg["arch"])
    if cfg.get("reduced"):
        mcfg = configs.reduced(mcfg)
    if cfg.get("compute_dtype"):
        mcfg = dataclasses.replace(mcfg, compute_dtype=cfg["compute_dtype"])
    model, params, _ = _init_model(mcfg, device, cfg["seed"])
    return model, params


def decode_run(device, model, params, cfg, run: dict, *,
               n_lanes: int) -> dict:
    """One drained DecodeCluster run of ``cfg``'s requests (on a mesh,
    every rank calls it): its scheduling integers, the served-token
    multiset and its times."""
    from repro_torch.serve.decode import DecodeCluster, DecodePolicy
    from repro_torch.serve.scheduler import Request

    run = dict(run)
    pol = DecodePolicy(steal=run.pop("steal", "queue"), **cfg["policy"])
    cluster = DecodeCluster(
        model, params, policy=pol, n_lanes=n_lanes, capacity=cfg["capacity"],
        straggler_threshold=float("inf"),
        device=_runtime_device(device, run["execution"]), **run)
    reqs = decode_requests(Request, cfg)
    sync(device)
    t0 = time.perf_counter()
    drive_decode(cluster, reqs, cfg["arrival"])
    sync(device)
    wall = time.perf_counter() - t0
    check(len(cluster.done) == len(reqs),
          f"decode served {len(cluster.done)} of {len(reqs)} requests")
    for r in reqs:
        check(r.output is not None and len(r.output) == r.max_new,
              f"request {r.rid} got {r.output} for max_new {r.max_new}")
    tele = cluster.telemetry
    summ = tele.summary()
    spreads = [(max(w.loads) - min(w.loads)) / max(np.mean(w.loads), 1.0)
               for w in tele.waves if max(w.loads) > 0]
    return dict(decode_integers(cluster),
                multiset=sorted(tuple(r.output) for r in reqs),
                served=[(r.prompt, r.output) for r in reqs],
                tokens=summ["tokens"], wall_s=wall,
                ms_per_round=wall * 1e3 / cluster.rounds,
                tokens_per_s=summ["tokens"] / wall,
                ttft_p99=summ["ttft_p99"], latency_p99=summ["latency_p99"],
                load_spread=float(np.mean(spreads)) if spreads else 0.0,
                backend=cluster.runtime.ops.resolved)


def scalar_decode_logits(model, params, prompt, served, cache_len: int,
                         device):
    """``prompt`` and then ``served`` teacher-forced through
    ``decode_step`` on a batch-1 cache of ``cache_len`` rows at one scalar
    position (the wave engine's path, which shares nothing per-row with
    the decode engine's): the logits from which each served token was
    chosen, ``(len(served), V)``."""
    import torch
    cache = model.make_cache(1, cache_len, device=device)
    seq = torch.tensor(list(prompt) + list(served), dtype=torch.int32,
                       device=device)
    rows = []
    for t in range(len(seq) - 1):
        logits, cache = model.decode_step(params, cache,
                                          seq[t:t + 1].reshape(1, 1))
        if t >= len(prompt) - 1:
            rows.append(logits[0, 0])
    return torch.stack(rows)


def decode_reference(model, params, runs: dict, cache_len: int,
                     device) -> dict:
    """Every request each run of ``runs`` served, held against
    :func:`scalar_decode_logits` in float32: each served token must be
    the reference's greedy choice up to the logits tolerance — its
    reference logit within ``2 * SERVE_TOL_F32 * (1 + max |logit|)`` of
    the reference's largest (two logit rows within the tolerance of each
    other can swap a near-tie and no more).  The reference is computed
    once per distinct (prompt, served) pair."""
    import torch
    memo, gaps, exact = {}, [], 0
    for res in runs.values():
        for prompt, served in res["served"]:
            key = (tuple(prompt), tuple(served))
            if key not in memo:
                L = scalar_decode_logits(model, params, prompt, served,
                                         cache_len, device)
                want = torch.tensor(served, device=L.device).long()
                gap = L.max(-1).values - L.gather(1, want[:, None])[:, 0]
                tol = 2 * SERVE_TOL_F32 * (1 + L.abs().max(-1).values)
                memo[key] = (gap.cpu().numpy(), tol.cpu().numpy(),
                             int((L.argmax(-1) == want).sum()))
            gap, tol, hits = memo[key]
            bad = np.nonzero(gap > tol)[0]
            check(bad.size == 0,
                  f"decode served token {bad[:1].tolist()} of prompt "
                  f"{list(prompt)[:8]}... (len {len(prompt)}) "
                  f"{gap[bad[:1]].tolist()} below the scalar path's greedy "
                  f"logit, past the tolerance {tol[bad[:1]].tolist()}")
            gaps.append(gap / tol)
            exact += hits
    ratio = np.concatenate(gaps)
    return {"tokens": int(ratio.size), "distinct_requests": len(memo),
            "greedy_exact": exact / ratio.size,
            "max_gap_over_tol": float(ratio.max())}


def phase_decode(device, counters, cfg, expect=None) -> dict:
    """Phase 10: PHASE10_RUNS of ``cfg`` on one card, each with the ring
    kernels' launch counters zeroed just before it and read just after,
    held to ``expect`` (the JAX package's integers) and to each other.
    Then the served tokens against the scalar-position path in float32
    (:func:`decode_reference`): ``cfg``'s own runs where it computes in
    float32, else PHASE10_REFERENCE's runs again in float32."""
    import torch
    model, params = _decode_model(cfg, device)
    # one untimed drain first: cuBLAS and the allocator warm up
    decode_run(device, model, params, cfg, PHASE10_RUNS[0][1],
               n_lanes=cfg["n_lanes"])
    runs = {}
    for name, run in PHASE10_RUNS:
        for k in DECODE_KERNELS:
            counters[k].launches = 0
        res = decode_run(device, model, params, cfg, run,
                         n_lanes=cfg["n_lanes"])
        res["launches"] = {k: counters[k].launches for k in DECODE_KERNELS}
        runs[name] = res
    pins = ("rounds", "stolen", "migrated", "stalls", "stamps")
    for name, res in runs.items():
        got = {k: res[k] for k in pins}
        if expect is not None:
            check(got == expect[name],
                  f"decode {name}: {got} != the JAX package's "
                  f"{expect[name]}")
        if device.type == "cuda":
            check(res["backend"] == "cuda", f"decode {name} routing "
                  f"{res['backend']!r} is not cuda")
    for name in ("vmap", "host"):
        check(runs[name]["stolen"] > 0, f"decode {name} stole nothing")
    check(runs["static"]["stolen"] == 0 and runs["static"]["migrated"] == 0,
          "the static baseline moved work")
    check(runs["migrate"]["migrated"] > 0, "decode migrate migrated nothing")
    check(runs["vmap"]["multiset"] == runs["host"]["multiset"],
          "vmap and host served different tokens")
    if device.type == "cuda":
        for name, res in runs.items():
            n, rounds = res["launches"], res["rounds"]
            check(n["ring_slice"] == rounds, f"decode {name}: K3 launched "
                  f"{n['ring_slice']} times in {rounds} rounds")
            check(n["ring_scatter"] > 0, f"decode {name}: K2 never launched")
            if name != "host":
                check(n["ring_gather"] == n["ring_transfer"] == rounds,
                      f"decode {name}: K1 / K4 launched {n['ring_gather']} "
                      f"/ {n['ring_transfer']} times in {rounds} rounds")
    pol = cfg["policy"]
    C = -(-(pol["max_prompt"] + pol["max_new"]) // pol["page_size"]) \
        * pol["page_size"]                        # the slots' cache rows
    ref_cfg = dict(cfg, compute_dtype="float32")
    if cfg.get("compute_dtype") == "float32":
        ref_runs = {n: runs[n] for n in PHASE10_REFERENCE}
    else:
        del model, params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        model, params = _decode_model(ref_cfg, device)
        ref_runs = {}
        for name in PHASE10_REFERENCE:
            res = decode_run(device, model, params, ref_cfg,
                             dict(PHASE10_RUNS)[name],
                             n_lanes=cfg["n_lanes"])
            got = {k: res[k] for k in pins}
            if expect is not None:
                check(got == expect[name],
                      f"decode {name} in float32: {got} != the JAX "
                      f"package's {expect[name]}")
            ref_runs[name] = res
    t0 = time.perf_counter()
    reference = decode_reference(model, params, ref_runs, C, device)
    reference.update(runs=list(ref_runs), s=time.perf_counter() - t0,
                     ms_per_round={n: r["ms_per_round"]
                                   for n, r in ref_runs.items()})
    del model, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"arch": cfg["arch"], "lanes": cfg["n_lanes"],
            "requests": cfg["n_requests"], "policy": cfg["policy"],
            "runs": {name: {k: v for k, v in res.items()
                            if k not in ("multiset", "served")}
                     for name, res in runs.items()},
            "multiset_vmap_eq_host": True,
            "float32_reference": reference}


def mesh_decode(device, cfg, n_lanes: int, execution: str) -> dict:
    """Phase 9's decode check on ``n_lanes`` lanes, stacked or one per
    rank: the steal-balanced and the migrating run's integers and
    served-token multisets."""
    model, params = _decode_model(cfg, device)
    out = {}
    for name, run in (("balanced", dict(execution=execution)),
                      ("migrate", dict(execution=execution,
                                       steal="migrate"))):
        res = decode_run(device, model, params, cfg, run, n_lanes=n_lanes)
        out[name] = {k: res[k] for k in ("rounds", "stolen", "migrated",
                                         "stalls", "stamps", "multiset",
                                         "ms_per_round")}
    return out


# ------------------------------------------------------------------ main


# ------------------------------- phase 11: training, MoE and the VLM prefix


def _arch_cfg(arch: str, *, reduced: bool = False, **changes):
    from repro_torch import configs
    cfg = configs.get(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    return dataclasses.replace(cfg, **changes)


def train_launches(cfg) -> dict:
    """Launches of each kernel per train step on ``cfg``'s path: a prefill
    wave's (:func:`serve_launches`) in the forward, and as many again
    when ``cfg.remat`` recomputes each group in the backward.  The
    backward of a launch is its plain version's and launches nothing."""
    return {n: k * (2 if cfg.remat else 1)
            for n, k in serve_launches(cfg).items()}


def train_batch(cfg, device, *, seed: int, batch: int, seq: int) -> dict:
    """The first batch of ``launch/train``'s pipeline (the work-stealing
    pipeline over ``synth_batch``) on ``device``."""
    from repro_torch.data.pipeline import WorkStealingPipeline
    from repro_torch.data.synthetic import synth_batch
    from repro_torch.launch.train import make_batch
    pipeline = WorkStealingPipeline(
        n_hosts=1, make_batch=lambda shard, step: synth_batch(
            seed, shard, step, batch, seq, cfg.vocab_size))
    return make_batch(cfg, pipeline.next_batch(0), device)


# Parameters whose gradient reaches them only through K6 (the attention
# projections) or K7 (the scan's inputs): a launch that autograd cannot
# see leaves them at exactly zero.
THROUGH_KERNELS = ("attn/wq", "attn/wk", "attn/wv", "ssm/w_x", "ssm/w_B",
                   "ssm/w_C", "ssm/w_dt", "ssm/A_log", "ssm/D")


def grad_stats(grads) -> dict:
    """Every gradient leaf finite (gated); the leaves of
    ``THROUGH_KERNELS`` non-zero in every layer (gated); and how many
    layer slices of the other leaves are all zero."""
    from repro_torch._tree import tree_leaves_with_path
    import torch
    zero_slices, leaves = {}, 0
    for key, g in tree_leaves_with_path(grads):
        leaves += 1
        check(bool(torch.isfinite(g).all()), f"gradient {key} not finite")
        lead = (2 if key.startswith("grouped/") else
                1 if key.startswith(("blocks/", "layers/", "tail/",
                                     "encoder/", "decoder/")) else 0)
        rows = int(np.prod(g.shape[:lead]))
        per_layer = g.reshape(rows, -1).abs().amax(1) > 0
        if key.endswith(THROUGH_KERNELS):
            check(bool(per_layer.all()),
                  f"gradient {key} is zero in layers "
                  f"{torch.nonzero(~per_layer).flatten().tolist()}")
        n = int((~per_layer).sum())
        if n:
            zero_slices[key] = n
    return {"leaves": leaves, "finite": True, "zero_layer_slices": zero_slices}


class _FirstGrads:
    """Wraps ``trainer.value_and_grad`` (what ``make_train_step`` calls)
    and keeps :func:`grad_stats` of the first step's gradients."""

    def __init__(self):
        from repro_torch.train import trainer
        self.mod, self.real, self.stats = trainer, trainer.value_and_grad, None
        trainer.value_and_grad = self

    def __call__(self, loss_fn, params, batch):
        loss, grads = self.real(loss_fn, params, batch)
        if self.stats is None:
            self.stats = grad_stats(grads)
        return loss, grads

    def restore(self):
        self.mod.value_and_grad = self.real


def grads_against_plain(model, params, batch, names) -> dict:
    """Loss and gradients through the kernels ``names`` against the same
    with their plain versions swapped in (float32 compute): the loss
    within ``TRAIN_LOSS_TOL`` (+ relative), each leaf within
    ``TRAIN_GRAD_TOL`` of its largest |g|."""
    import torch
    from repro_torch._tree import tree_leaves_with_path
    from repro_torch.train.trainer import value_and_grad
    loss_k, g_k = value_and_grad(model.loss_fn, params, batch)
    with _plain(names):
        loss_p, g_p = value_and_grad(model.loss_fn, params, batch)
    loss_k, loss_p = float(loss_k), float(loss_p)
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL * (1 + abs(loss_p)),
          f"float32 loss {loss_k} through the kernels, {loss_p} plain")
    worst, leaves = 0.0, 0
    for (key, a), (_, b) in zip(tree_leaves_with_path(g_k),
                                tree_leaves_with_path(g_p)):
        for run, g in (("kernel", a), ("plain", b)):
            bad = ~torch.isfinite(g)
            check(not bool(bad.any()),
                  f"float32 gradient {key} of the {run} step: "
                  f"{int(bad.sum())} of {g.numel()} elements not finite, "
                  f"in rows {torch.nonzero(bad.reshape(g.shape[0], -1).any(1)).flatten()[:8].tolist()}")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        check(err <= TRAIN_GRAD_TOL * scale + 1e-30,
              f"float32 gradient {key}: {err} from the plain step's, "
              f"tolerance {TRAIN_GRAD_TOL} x {scale}")
        worst = max(worst, err / scale if scale else 0.0)
        leaves += 1
    return {"loss_kernel": loss_k, "loss_plain": loss_p, "leaves": leaves,
            "max_grad_err_over_leaf_max": worst}


def _peak_gb(device):
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _reset_peak(device):
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _check_step_launches(device, expect, launches, launches_tc,
                         tensor_core: bool, what: str):
    """On the card: each kernel ``expect`` times in the step, and all of
    them (bf16) or none (float32, the SIMT kernels) on the tensor-core
    route."""
    if device.type != "cuda":
        return
    for name, n in expect.items():
        check(launches[name] == n, f"{what}: {name} launched "
                                   f"{launches[name]} times, not {n}")
        tc = launches_tc.get(name, 0)
        check(tc == (n if tensor_core else 0),
              f"{what}: {name} {tc} of {n} launches on the tensor-core "
              f"route")


def train_run(device, c, *, reduced: bool = False, layers=None) -> dict:
    """``c["steps"]`` steps of ``make_train_step`` on one repeated batch of
    the pipeline (bf16 compute, float32 parameters, remat), with the
    path's launch counters zeroed just before each step and read just
    after; before them, with ``c["compare"]``, the first step's loss and
    gradients in float32 through the kernels (their SIMT routes) against
    the plain versions'.  Gates: finite losses, the last below the first
    (over more than one step), every gradient leaf of step 1 finite and
    those of ``THROUGH_KERNELS`` non-zero in every layer, the launches."""
    import torch
    from repro_torch.models.zoo import build_model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step

    changes = {} if layers is None else {"n_layers": layers}
    cfg = _arch_cfg(c["arch"], reduced=reduced, **changes)
    model, params, init_s = _init_model(cfg, device, c["seed"])
    batch = train_batch(cfg, device, seed=c["seed"], batch=c["batch"],
                        seq=c["seq"])
    expect = train_launches(cfg)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "params": cfg.param_count(), "batch": [c["batch"], c["seq"]],
           "init_s": init_s, "launches_expected_per_step": expect}
    if "frames" in batch:
        # launch/train's stub frames are ones: every encoder position the
        # same, so the encoder's q / k and cross-attention's k would get
        # exactly zero gradient; draw them from the seed instead
        gen = torch.Generator(device=device).manual_seed(c["seed"])
        batch = dict(batch, frames=torch.randn(
            batch["frames"].shape, generator=gen, device=device))
    if c.get("compare"):
        f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
        cmp, wall, n, n_tc = _run_counted(
            device, expect,
            lambda: grads_against_plain(f32, params, batch, list(expect)))
        _check_step_launches(device, expect, n, n_tc, False,
                             "float32 step")
        out["float32_vs_plain"] = dict(cmp, wall_s=wall, launches=n)
        gc.collect()

    step = make_train_step(model, AdamWConfig(
        lr=c["lr"], warmup_steps=c["warmup_steps"],
        total_steps=c["steps"]))
    opt = adamw_init(params)
    tap = _FirstGrads()
    losses, ms, launches = [], [], []
    _reset_peak(device)
    try:
        for i in range(c["steps"]):
            (params, opt, met), wall, n, n_tc = _run_counted(
                device, expect, lambda: step(params, opt, batch))
            _check_step_launches(device, expect, n, n_tc,
                                 cfg.compute_dtype == "bfloat16",
                                 f"train step {i}")
            losses.append(float(met["loss"]))
            ms.append(wall * 1e3)
            launches.append(n)
    finally:
        tap.restore()
    check(all(np.isfinite(losses)), f"losses {losses}")
    if len(losses) > 1:
        check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens = c["batch"] * c["seq"]
    warm = ms[1:] or ms
    out.update(losses=losses, ms_per_step=ms,
               ms_per_step_warm=sum(warm) / len(warm),
               tokens_per_s=tokens * 1e3 / (sum(warm) / len(warm)),
               peak_gb=_peak_gb(device), launches=launches,
               grads_step1=tap.stats,
               grad_norm_last=float(met["grad_norm"]))
    return out


class _RouteTap:
    """Wraps ``moe.route_with_bulk_steal`` (what every MoE layer calls).
    Counting: against the drop baseline's plan for the same
    probabilities, the assignments the bulk steal rerouted and those it
    still dropped, on the device; and each prefill-sized call's inputs,
    for the plan check.  ``record`` / ``replay``: the plans of one
    prefill, handed back in order to a second prefill (whose own plans
    are computed and compared: ``flips``)."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.real = moe, moe.route_with_bulk_steal
        self.counting, self.record, self.replay = True, None, None
        self.calls, self.rerouted, self.dropped, self.baseline_dropped = \
            0, 0, 0, 0
        self.flips, self.prefill_calls = 0, []
        moe.route_with_bulk_steal = self

    def __call__(self, probs, top_k, capacity, bulk_steal=True):
        plan = self.real(probs, top_k, capacity, bulk_steal)
        if self.replay is not None:
            mine, plan = plan, self.replay.pop(0)
            self.flips = self.flips + (mine[0] != plan[0]).sum()
            return plan
        if self.record is not None:
            self.record.append(plan)
        elif self.counting and bulk_steal:
            base = self.real(probs, top_k, capacity, False)
            moved = plan[3] & (plan[0] != base[0])
            self.calls += 1
            self.rerouted = self.rerouted + moved.sum()
            self.dropped = self.dropped + (~plan[3]).sum()
            self.baseline_dropped = self.baseline_dropped + (~base[3]).sum()
            if probs.shape[0] > 64:
                self.prefill_calls.append((moved.sum(), probs, top_k,
                                           capacity))
        return plan

    def restore(self):
        self.mod.route_with_bulk_steal = self.real

    def plan_on_the_cpu(self) -> dict:
        """The prefill call whose steal moved the most assignments,
        routed again on its device and on the CPU from the same
        probabilities: expert, slot and valid bit-equal (gated)."""
        import torch
        if not self.prefill_calls:
            return {"calls": 0}
        moved, probs, k, cap = max(self.prefill_calls,
                                   key=lambda t: int(t[0]))
        dev = self.real(probs, k, cap, True)
        cpu = self.real(probs.cpu(), k, cap, True)
        for name, a, b in zip(("expert", "slot", "weight", "valid"), dev,
                              cpu):
            if name != "weight":
                check(torch.equal(a.cpu(), b),
                      f"routing plan's {name} on {probs.device} differs "
                      f"from the CPU's")
        return {"tokens": probs.shape[0], "top_k": k, "capacity": cap,
                "rerouted": int(moved), "bit_equal": True,
                "weight_max_abs_diff": float((dev[2].cpu() - cpu[2]).abs()
                                             .max())}


def moe_first_wave(tap, cfg, params, tokens, logits_kernel, names):
    """The first wave's float32 last-position logits through the kernels
    against the plain versions', the second prefill replaying the first
    one's routing plans: a near-tie in the router that the two
    attentions' rounding would flip is counted (``plan_flips``) instead of
    compared."""
    from repro_torch.models.zoo import build_model
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    tap.record = []
    try:
        kern = f32.prefill(params, tokens)[0]
        plans, tap.record = tap.record, None
        tap.replay, tap.flips = list(plans), 0
        with _plain(names):
            plain = f32.prefill(params, tokens)[0]
        check(not tap.replay, "the plain prefill routed fewer times")
    finally:
        tap.record, tap.replay = None, None
    err = _close(kern, plain, SERVE_TOL_F32,
                 f"MoE first wave, float32 compute: "
                 f"{'+'.join(names)} vs plain")
    return {"first_wave_f32_max_abs_err": err,
            "first_wave_routing_calls": len(plans),
            "first_wave_plan_flips": int(tap.flips),
            "first_wave_greedy_agreement_bf16_f32": float(
                (logits_kernel.argmax(-1) == kern.argmax(-1)).double()
                .mean())}


def phase_moe(device, c, *, reduced: bool = False) -> dict:
    """(b) The MoE model (``c["n_layers"]`` of its layers) served in phase
    4's setup with the routing tap counting; every request in full,
    ``stolen > 0``, K6 once a layer and wave, the steal rerouting and
    dropping nothing, the plan on the card equal to the CPU's, the first
    wave's float32 logits equal to the plain versions' under one plan.
    Then one train step at ``c["train_layers"]`` layers."""
    import torch
    cfg = _arch_cfg(c["arch"], reduced=reduced, n_layers=c["n_layers"])
    tap = _RouteTap()
    try:
        serve = phase_serve(device, cfg=cfg, **c["serve"],
                            first_wave=functools.partial(moe_first_wave,
                                                         tap))
        routing = {"calls": tap.calls, "rerouted": int(tap.rerouted),
                   "dropped": int(tap.dropped),
                   "dropped_without_steal": int(tap.baseline_dropped),
                   "plan_vs_cpu": tap.plan_on_the_cpu()}
    finally:
        tap.restore()
    check(routing["rerouted"] > 0, "the bulk steal rerouted nothing")
    check(routing["dropped"] == 0,
          f"the bulk steal dropped {routing['dropped']} assignments")
    serve["routing"] = routing
    del tap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    train = train_run(device, c["train"], reduced=reduced,
                      layers=c["train"]["layers"])
    return {"serve": serve, "train": train}


def vlm_prefill(device, c, *, reduced: bool = False) -> dict:
    """(d) One prefill of ``c["n_prompts"]`` prompts behind their patch
    prefix (random patches from the seed), K6 once a layer on the
    tensor-core route in bf16; the float32 last-position logits through
    K6 (SIMT) against the plain version's within ``SERVE_TOL_F32``."""
    import torch
    from repro_torch.models.zoo import build_model
    cfg = _arch_cfg(c["arch"], reduced=reduced)
    model, params, init_s = _init_model(cfg, device, c["seed"])
    rng = np.random.default_rng(c["seed"])
    B, S = c["n_prompts"], c["text_len"]
    tokens = torch.tensor(rng.integers(1, cfg.vocab_size, (B, S)),
                          dtype=torch.int32, device=device)
    patches = torch.tensor(rng.standard_normal(
        (B, cfg.n_patches, cfg.frontend_dim)), dtype=torch.float32,
        device=device)
    expect = serve_launches(cfg)
    (logits, cache), wall, n, n_tc = _run_counted(
        device, expect, lambda: model.prefill(params, tokens, patches))
    _check_step_launches(device, expect, n, n_tc, True, "vlm prefill")
    check(cache["pos"] == cfg.n_patches + S,
          f"cache at {cache['pos']}, not {cfg.n_patches + S}")
    check(bool(torch.isfinite(logits).all()), "vlm logits not finite")
    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    kern, wall32, n32, n32_tc = _run_counted(
        device, expect, lambda: f32.prefill(params, tokens, patches)[0])
    _check_step_launches(device, expect, n32, n32_tc, False,
                         "vlm float32 prefill")
    with _plain(list(expect)):
        plain = f32.prefill(params, tokens, patches)[0]
    err = _close(kern, plain, SERVE_TOL_F32,
                 "vlm prefill, float32 compute: K6 vs plain")
    return {"arch": cfg.name, "params": cfg.param_count(), "init_s": init_s,
            "shape": [B, cfg.n_patches, S], "prefill_ms": wall * 1e3,
            "prefill_f32_ms": wall32 * 1e3, "launches": n,
            "launches_tensor_core": n_tc, "f32_max_abs_err": err,
            "greedy_agreement_bf16_f32": float(
                (logits.argmax(-1) == kern.argmax(-1)).double().mean())}


def phase_train(device, cfg) -> dict:
    """Phase 11: (a) dense training, (b) MoE serving and a train step, (c)
    SSM training, (d) the VLM prefix; each part's model freed before the
    next."""
    import torch
    reduced = cfg.get("reduced", False)
    out = {}
    for name, fn in (("dense", train_run), ("moe", phase_moe),
                     ("ssm", train_run), ("vlm", vlm_prefill)):
        part = dict(cfg[name])
        layers = part.pop("layers", None) if fn is train_run else None
        t0 = time.perf_counter()
        if fn is train_run:
            out[name] = fn(device, part, reduced=reduced, layers=layers)
        else:
            out[name] = fn(device, part, reduced=reduced)
        out[name]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


# ------------------------------------------ phase 12: the enc-dec family


class _AttnModes:
    """Wraps ``encdec.attention`` (every attention an ``EncDecLM`` prefill
    or forward calls) and splits by mode the calls and the K6 launches
    they make, read from K6's own counters around each call: the
    encoder's bidirectional self-attention, the decoder's causal
    self-attention, and cross-attention."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.models import encdec
        self.mod, self.real, self.mha = encdec, encdec.attention, \
            flash_ops.mha
        self.calls = {"encoder": 0, "self": 0, "cross": 0}
        self.launches, self.launches_tc = dict(self.calls), dict(self.calls)
        encdec.attention = self

    def __call__(self, p, x, cfg, compute_dtype, **kw):
        mode = ("cross" if kw.get("kv_x") is not None else
                "self" if cfg.causal else "encoder")
        self.calls[mode] += 1
        n, tc = self.mha.launches, self.mha.launches_tc
        out = self.real(p, x, cfg, compute_dtype, **kw)
        self.launches[mode] += self.mha.launches - n
        self.launches_tc[mode] += self.mha.launches_tc - tc
        return out

    def restore(self):
        self.mod.attention = self.real


def encdec_serve(device, c, *, reduced: bool = False) -> dict:
    """(a) Prefill and greedy decode: ``c["batch"]`` utterances of
    ``c["frames"]`` seeded stub frames with target prefixes of
    ``c["prefix"]`` tokens, bf16 compute; K6 once per encoder layer and
    twice per decoder layer (self, cross), all on the tensor-core route.
    Then ``c["new"]`` greedy decode steps.  Gates: in float32 the prefill
    logits through K6 (SIMT) within ``SERVE_TOL_F32`` of the plain
    version's, the bf16 kernel prefill's mean distance from them at most
    ``SERVE_BF16_RATIO`` times the bf16 plain prefill's, and
    ``c["f32_steps"]`` float32 decode steps after the kernel prefill and
    after the plain one within ``SERVE_TOL_F32`` of each other."""
    import torch
    from repro_torch.models.zoo import build_model
    cfg = _arch_cfg(c["arch"], reduced=reduced)
    model, params, init_s = _init_model(cfg, device, c["seed"])
    rng = np.random.default_rng(c["seed"])
    B, F, S = c["batch"], c["frames"], c["prefix"]
    frames = torch.tensor(rng.standard_normal((B, F, cfg.frontend_dim)),
                          dtype=torch.float32, device=device)
    tokens = torch.tensor(rng.integers(1, cfg.vocab_size, (B, S)),
                          dtype=torch.int32, device=device)
    expect = serve_launches(cfg)
    modes = _AttnModes()
    try:
        (logits, cache), wall, n, n_tc = _run_counted(
            device, expect, lambda: model.prefill(params, frames, tokens))
    finally:
        modes.restore()
    _check_step_launches(device, expect, n, n_tc, True, "encdec prefill")
    want_modes = {"encoder": cfg.n_encoder_layers, "self": cfg.n_layers,
                  "cross": cfg.n_layers}
    check(modes.calls == want_modes,
          f"attention calls by mode {modes.calls}, not {want_modes}")
    if device.type == "cuda":
        check(modes.launches == want_modes == modes.launches_tc,
              f"K6 launches by mode {modes.launches} (tensor-core "
              f"{modes.launches_tc}), not {want_modes}")
    check(bool(torch.isfinite(logits).all()), "encdec logits not finite")
    check(tuple(cache["cross"]["k"].shape[1:3]) == (B, F)
          and tuple(cache["self"]["k"].shape[1:3]) == (B, S),
          "encdec cache shapes")

    cache = model.grow_cache(cache, S + c["new"])
    tok, decode_ms = logits.argmax(-1).int(), []
    for _ in range(c["new"]):
        sync(device)
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, tok)
        sync(device)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(lg).all()), "encdec decode not finite")
        tok = lg.argmax(-1).int()

    f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"))
    (kern, kcache), wall32, n32, n32_tc = _run_counted(
        device, expect, lambda: f32.prefill(params, frames, tokens))
    _check_step_launches(device, expect, n32, n32_tc, False,
                         "encdec float32 prefill")
    with _plain(list(expect)):
        plain, pcache = f32.prefill(params, frames, tokens)
        plain_bf16 = model.prefill(params, frames, tokens)[0]
    err = _close(kern, plain, SERVE_TOL_F32,
                 "encdec prefill, float32 compute: K6 vs plain")
    dev_k = float((logits - plain).abs().mean())
    dev_p = float((plain_bf16 - plain).abs().mean())
    check(dev_k <= SERVE_BF16_RATIO * dev_p,
          f"encdec bf16 prefill {dev_k} from float32, the plain bf16 "
          f"prefill {dev_p}")
    kcache = f32.grow_cache(kcache, S + c["f32_steps"])
    pcache = f32.grow_cache(pcache, S + c["f32_steps"])
    tok, decode_err = kern.argmax(-1).int(), 0.0
    for t in range(c["f32_steps"]):
        lk, kcache = f32.decode_step(params, kcache, tok)
        lp, pcache = f32.decode_step(params, pcache, tok)
        decode_err = max(decode_err, _close(
            lk, lp, SERVE_TOL_F32, f"encdec float32 decode step {t} after "
                                   f"the kernel and the plain prefill"))
        tok = lk.argmax(-1).int()
    warm = decode_ms[1:] or decode_ms
    return {"arch": cfg.name, "params": cfg.param_count(), "init_s": init_s,
            "shape": {"utterances": B, "frames": F, "prefix": S},
            "prefill_ms": wall * 1e3, "prefill_f32_ms": wall32 * 1e3,
            "launches": n, "launches_tensor_core": n_tc,
            "calls_by_mode": modes.calls,
            "launches_by_mode": modes.launches,
            "decode_ms_per_step": sum(warm) / len(warm),
            "decode_steps": c["new"],
            "f32_max_abs_err": err,
            "bf16_mean_dev_from_f32": {"kernel": dev_k, "plain": dev_p},
            "f32_decode_max_abs_err": decode_err}


def phase_encdec(device, cfg) -> dict:
    """Phase 12: (a) seamless-m4t-medium's prefill and decode, (b) its
    training (``train_run``), the first model freed before the second."""
    import torch
    reduced = cfg.get("reduced", False)
    out = {}
    t0 = time.perf_counter()
    out["serve"] = encdec_serve(device, cfg["serve"], reduced=reduced)
    out["serve"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["train"] = train_run(device, cfg["train"], reduced=reduced)
    out["train"]["wall_s"] = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ------------------------------------- phase 13: the sharded-model path


def _sharded_model(device, c, *, reduced: bool, **changes):
    """``c``'s model (decode / MoE bodies as ``changes`` say) and a
    function that makes its parameters from ``c["seed"]`` on ``device``."""
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.zoo import build_model
    kw = dict(param_dtype=c["param_dtype"], compute_dtype=c["compute_dtype"],
              **changes)
    if c.get("layers"):
        kw["n_layers"] = c["layers"]
    cfg = _arch_cfg(c["arch"], reduced=reduced, **kw)
    model = build_model(cfg, ParallelConfig())
    return model, lambda: model.init(
        torch.Generator(device=device).manual_seed(c["seed"]))


def _sharded_tokens(cfg, c) -> np.ndarray:
    return np.random.default_rng(c["seed"]).integers(
        1, cfg.vocab_size, (c["batch"], c["prompt"] + c.get("steps", 0))
    ).astype(np.int32)


def flash_reference(device, c, *, reduced: bool, groups: int) -> dict:
    """The unsharded decode: ``groups`` slices of the ``c["batch"]`` rows
    (one a data rank) each prefilled, grown to ``c["cache"]`` and decoded
    ``c["steps"]`` teacher-forced steps, as the ranks do theirs; the
    logits (steps, B, V) on the host, ms per step and per prefill.  Also
    all rows in one batch: how far two correct decodes of the same rows
    in other batch shapes lie apart (``batch_shape_max_abs_dev``); and
    with ``c["f32_reference"]`` the same slices in float32 compute on the
    same parameters (``f32_logits``), the yardstick of a bf16 run's
    accuracy."""
    import torch
    from repro_torch.models.zoo import build_model
    model, init = _sharded_model(device, c, reduced=reduced)
    params = init()
    toks = torch.from_numpy(_sharded_tokens(model.cfg, c)).to(device)
    P0, B = c["prompt"], c["batch"]

    def decode(rows, model=model):
        sync(device)
        t0 = time.perf_counter()
        _, cache = model.prefill(params, toks[rows, :P0])
        sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        cache = model.grow_cache(cache, c["cache"])
        out, ms = [], []
        for t in range(c["steps"]):
            sync(device)
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache,
                                          toks[rows, P0 + t:P0 + t + 1])
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(lg[:, 0].float().cpu())
        del cache
        return torch.stack(out), ms, prefill_ms

    slices = [slice(g * B // groups, (g + 1) * B // groups)
              for g in range(groups)]
    parts = [decode(rows) for rows in slices]
    whole = decode(slice(0, B))
    logits = torch.cat([p[0] for p in parts], dim=1)
    ms = [m for p in parts for m in p[1][1:]]
    f32 = None
    if c.get("f32_reference"):
        m32 = build_model(dataclasses.replace(model.cfg,
                                              compute_dtype="float32"))
        f32 = torch.cat([decode(rows, m32)[0] for rows in slices], dim=1)
    return {"logits": logits, "f32_logits": f32,
            "ms_per_step": sum(ms) / len(ms),
            "prefill_ms": [p[2] for p in parts],
            "batch_shape_max_abs_dev": float((whole[0] - logits).abs()
                                             .max()),
            "whole_batch_ms_per_step": sum(whole[1][1:])
            / max(len(whole[1]) - 1, 1)}


def _flash_rank(mesh, device, c, ref_path, *, reduced: bool) -> dict:
    """One rank of (a): prefill this data rank's rows through K6, grow the
    cache, keep this model rank's slice (``shard_cache``) and decode
    ``c["steps"]`` teacher-forced steps under the mesh, flash-decoding on
    every layer; each step's largest distance from the unsharded
    reference's rows, absolute and over ``c["tol"]`` (absolute and
    relative), which the parent gates; no NaN."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention as attn_mod
    model, init = _sharded_model(device, c, reduced=reduced,
                                 decode_impl="flash_shardmap")
    params = init()
    d, nd = mesh.coords["data"], mesh.shape["data"]
    rows = slice(d * c["batch"] // nd, (d + 1) * c["batch"] // nd)
    toks = torch.from_numpy(_sharded_tokens(model.cfg, c)[rows]).to(device)
    P0 = c["prompt"]
    flash_ops.mha.launches = flash_ops.mha.launches_tc = 0
    sync(device)
    t0 = time.perf_counter()
    _, cache = model.prefill(params, toks[:, :P0])
    sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = (flash_ops.mha.launches, flash_ops.mha.launches_tc)
    if device.type == "cuda":
        check(launches[0] == model.cfg.n_layers,
              f"rank {mesh.rank}: K6 launched {launches[0]} times in the "
              f"prefill, not {model.cfg.n_layers}")
        check(launches[1] == (launches[0] if c["compute_dtype"] ==
                              "bfloat16" else 0),
              f"rank {mesh.rank}: {launches[1]} tensor-core launches")
    local = model.shard_cache(model.grow_cache(cache, c["cache"]), mesh)
    del cache
    C_loc = c["cache"] // mesh.shape["model"]
    check(local["g0"].get("seq_len") == c["cache"]
          and local["g0"]["k"].shape[2] == C_loc,
          f"rank {mesh.rank}: cache slice {tuple(local['g0']['k'].shape)}")
    valid_slots = max(0, min(C_loc, P0 + 1 - mesh.coords["model"] * C_loc))
    refs = torch.load(ref_path)
    ref = refs["logits"][:, rows]
    ref32 = None if refs["f32"] is None else refs["f32"][:, rows]
    del refs
    dev_sharded = dev_unsharded = 0.0
    real, taken = attn_mod.decode_attention_shardmap, [0]

    def counted(*a, **kw):
        out = real(*a, **kw)
        taken[0] += out is not None
        return out

    attn_mod.decode_attention_shardmap = counted
    worst, worst_rel, ms = [], [], []
    try:
        with mesh:
            for t in range(c["steps"]):
                sync(device)
                t0 = time.perf_counter()
                lg, local = model.decode_step(params, local,
                                              toks[:, P0 + t:P0 + t + 1])
                sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
                got = lg[:, 0].float().cpu()
                check(not bool(torch.isnan(got).any()),
                      f"rank {mesh.rank}: NaN logits at step {t}")
                diff = (got - ref[t]).abs()
                bound = c["tol"] + c["tol"] * ref[t].abs()
                worst.append(float(diff.max()))
                worst_rel.append(float((diff / bound).max()))
                if ref32 is not None:
                    dev_sharded += float((got - ref32[t]).abs().mean())
                    dev_unsharded += float((ref[t] - ref32[t]).abs()
                                           .mean())
    finally:
        attn_mod.decode_attention_shardmap = real
    check(taken[0] == c["steps"] * model.cfg.n_layers,
          f"rank {mesh.rank}: flash-decoding taken {taken[0]} times")
    warm = ms[1:] or ms
    steps = c["steps"]
    return {"max_abs_err": max(worst), "max_err_over_tol": max(worst_rel),
            "max_abs_err_by_step": worst,
            "mean_dev_from_f32": (None if ref32 is None else
                                  {"sharded": dev_sharded / steps,
                                   "unsharded": dev_unsharded / steps}),
            "prefill_ms": prefill_ms, "prefill_launches": launches[0],
            "prefill_launches_tensor_core": launches[1],
            "decode_ms_per_step": sum(warm) / len(warm),
            "flash_decode_calls": taken[0],
            "valid_slots_at_first_step": valid_slots}


def _plan_digests(calls) -> list:
    """SHA-256 digests (16 hex) of each routing plan's expert, slot and
    valid tensors."""
    return [_digest(np.concatenate([np.asarray(t.cpu().numpy(), np.int64)
                                    .reshape(-1) for t in (e, s, v)]))
            for e, s, _, v in calls]


class _PlanTap:
    """Wraps ``moe.route_with_bulk_steal`` and keeps every plan."""

    def __init__(self):
        from repro_torch.models import moe
        self.mod, self.real, self.plans = moe, moe.route_with_bulk_steal, []
        moe.route_with_bulk_steal = self

    def __call__(self, *a, **kw):
        plan = self.real(*a, **kw)
        self.plans.append(plan)
        return plan

    def restore(self):
        self.mod.route_with_bulk_steal = self.real


def moe_reference(device, c, *, reduced: bool) -> dict:
    """The dispatch run whole (``moe_impl="gspmd"``): each data rank's rows
    prefilled on their own (the routing's scope is a rank's tokens),
    their last logits on the host, their plans' digests, ms per
    prefill."""
    import torch
    model, init = _sharded_model(device, c, reduced=reduced,
                                 moe_impl="gspmd")
    params = init()
    toks = torch.from_numpy(_sharded_tokens(model.cfg, c)).to(device)
    nd = c["data"]
    out = {"logits": [], "plans": [], "ms": []}
    for d in range(nd):
        rows = slice(d * c["batch"] // nd, (d + 1) * c["batch"] // nd)
        tap = _PlanTap()
        try:
            sync(device)
            t0 = time.perf_counter()
            lg, _ = model.prefill(params, toks[rows])
            sync(device)
        finally:
            tap.restore()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(lg[:, 0].float().cpu())
        out["plans"].append(_plan_digests(tap.plans))
    return out


def _moe_rank(mesh, device, c, ref_path, *, reduced: bool) -> dict:
    """One rank of (b): the full parameters made in turns (one rank at a
    time, each keeping its model rank's experts: ``shard_params``), then
    this data rank's prefill under the mesh, every MoE layer through the
    EP body; its last logits' distance from the reference's over 2e-5 +
    2e-4 |x|, and whether its routing plans are bit-equal to the
    reference's (the parent gates both)."""
    import torch
    from repro_torch.models import moe as moe_mod
    model, init = _sharded_model(device, c, reduced=reduced,
                                 moe_impl="ep_shardmap")
    local = None
    for turn in range(int(np.prod(list(mesh.shape.values())))):
        if turn == mesh.rank:
            full = init()
            local = model.shard_params(full, mesh)
            del full
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        mesh.barrier()
    tp = mesh.shape["model"]
    held = local["blocks"]["g0"]["moe"]["w_gate"].shape[1]
    check(held == model.cfg.n_experts // tp,
          f"rank {mesh.rank} holds {held} experts")
    d, nd = mesh.coords["data"], mesh.shape["data"]
    rows = slice(d * c["batch"] // nd, (d + 1) * c["batch"] // nd)
    toks = torch.from_numpy(_sharded_tokens(model.cfg, c)[rows]).to(device)
    ref = torch.load(ref_path)
    real, taken = moe_mod.moe_apply_ep_shardmap, [0]

    def counted(*a, **kw):
        out = real(*a, **kw)
        taken[0] += out is not None
        return out

    moe_mod.moe_apply_ep_shardmap = counted
    tap = _PlanTap()
    try:
        with mesh:
            sync(device)
            t0 = time.perf_counter()
            lg, _ = model.prefill(local, toks)
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        tap.restore()
        moe_mod.moe_apply_ep_shardmap = real
    got, want = lg[:, 0].float().cpu(), ref["logits"][d]
    diff = (got - want).abs()
    plans = _plan_digests(tap.plans)
    check(taken[0] == model.cfg.n_layers,
          f"rank {mesh.rank}: the EP body taken {taken[0]} times")
    return {"max_abs_err": float(diff.max()),
            "max_err_over_tol": float((diff / (2e-5 + 2e-4 * want.abs()))
                                      .max()),
            "finite": bool(torch.isfinite(got).all()), "prefill_ms": ms,
            "experts_held": int(held), "ep_calls": taken[0],
            "plans_bit_equal": plans == ref["plans"][d],
            "plan_calls": len(plans)}


def _sharded_rank(rank: int, cfg: dict, device_type: str, ref_dir: str,
                  reduced: bool) -> dict:
    """One rank of phase 13: (a) flash-decoding in both precisions, then
    (b) expert-parallel MoE, each part's model freed before the next."""
    import torch
    _port()
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import transformer
    device = _rank_device(rank, device_type)
    mesh = make_model_mesh(*cfg["mesh"], device=device)
    if cfg.get("seq_shard_min"):
        transformer._SEQ_SHARD_MIN = cfg["seq_shard_min"]
    out = {"coords": mesh.coords}
    for name in ("flash", "flash_f32"):
        out[name] = _flash_rank(mesh, device, cfg[name],
                                Path(ref_dir) / f"{name}.pt",
                                reduced=reduced)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["moe"] = _moe_rank(mesh, device, cfg["moe"],
                           Path(ref_dir) / "moe.pt", reduced=reduced)
    return out


def phase_sharded(device, cfg) -> dict:
    """Phase 13: the unsharded references in this process (freed before
    the spawn), then ``prod(mesh)`` gloo ranks on the one card as a model
    mesh, each measuring its results against the references; the gates
    over every rank's."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import run_workers
    reduced = cfg.get("reduced", False)
    ref_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    out = {}
    try:
        for name in ("flash", "flash_f32"):
            ref = flash_reference(device, cfg[name], reduced=reduced,
                                  groups=cfg["mesh"][0][0])
            torch.save({"logits": ref.pop("logits"),
                        "f32": ref.pop("f32_logits")}, ref_dir / f"{name}.pt")
            out[name] = {f"unsharded_{k}": v for k, v in ref.items()}
            del ref
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        moe = moe_reference(device, dict(cfg["moe"],
                                         data=cfg["mesh"][0][0]),
                            reduced=reduced)
        torch.save(moe, ref_dir / "moe.pt")
        out["moe"] = {"unsharded_prefill_ms_per_data_rank": moe["ms"]}
        del moe
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_workers(functools.partial(
            _sharded_rank, cfg=cfg, device_type=device.type,
            ref_dir=str(ref_dir), reduced=reduced),
            int(np.prod(cfg["mesh"][0])), backend="gloo",
            timeout=cfg["timeout"])
        wall = time.perf_counter() - t0
    finally:
        import shutil
        shutil.rmtree(ref_dir, ignore_errors=True)
    for name in ("flash", "flash_f32", "moe"):
        rows = [r[name] for r in ranks]
        keys = [k for k in rows[0]
                if isinstance(rows[0][k], (int, float, list, dict))]
        out[name].update({k: [r[k] for r in rows] for k in keys})
        c = cfg[name]
        out[name]["config"] = {k: c[k] for k in c if k != "seed"}
    out.update(coords=[r["coords"] for r in ranks], spawn_wall_s=wall,
               transport="gloo, staged through the host",
               mesh=dict(zip(cfg["mesh"][1], cfg["mesh"][0])))
    for name in ("flash", "flash_f32", "moe"):
        if cfg[name].get("f32_reference"):
            # bf16: as accurate as the unsharded decode on the mean; on
            # the max within the JAX package's bound, or (at full width,
            # where bf16 rounding alone passes it) no farther from the
            # unsharded decode than twice the distance of two correct
            # unsharded decodes (batches of 8 and 16)
            witness = out[name]["unsharded_batch_shape_max_abs_dev"]
            for r, (dev, err, rel) in enumerate(zip(
                    out[name]["mean_dev_from_f32"],
                    out[name]["max_abs_err"],
                    out[name]["max_err_over_tol"])):
                check(dev["sharded"] <= SERVE_BF16_RATIO * dev["unsharded"],
                      f"rank {r}: sharded bf16 decode {dev['sharded']} "
                      f"from float32, the unsharded {dev['unsharded']}")
                check(rel <= 1.0 or err <= SHARDED_BF16_WITNESS_RATIO
                      * witness,
                      f"rank {r}: sharded bf16 decode {err} from the "
                      f"unsharded one ({rel} x the {cfg[name]['tol']} "
                      f"bound), two unsharded decodes {witness} apart")
            continue
        worst = max(out[name]["max_err_over_tol"])
        check(worst <= 1.0,
              f"sharded {name}: {max(out[name]['max_abs_err'])} from the "
              f"unsharded run, {worst} x its tolerance")
    check(all(out["moe"]["plans_bit_equal"]) and all(out["moe"]["finite"]),
          "EP routing plans differ from the whole dispatch's, or its "
          "logits are not finite")
    return out


# ------------------------------------------- phase 15: the sharded step


def _step15_model(c, *, reduced: bool, pods: bool = False):
    """The case's model (the batch over the pod axis too on a mesh with
    pods, as the JAX package's multi-pod plan has it)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.zoo import build_model
    kw = dict(param_dtype=c["param_dtype"], compute_dtype=c["compute_dtype"])
    if c.get("layers"):
        kw["n_layers"] = c["layers"]
    cfg = _arch_cfg(c["arch"], reduced=reduced, **kw)
    return build_model(cfg, ParallelConfig(pod_axis="pod" if pods
                                           else None))


def _step15_batches(cfg, c) -> list:
    """``c["steps"]`` seeded numpy batches of tokens and labels."""
    rng = np.random.default_rng(c["seed"] + 1)
    out = []
    for _ in range(c["steps"]):
        t = rng.integers(1, cfg.vocab_size, (c["batch"], c["seq"] + 1)
                         ).astype(np.int64)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _tensors15(batch, device, rows=slice(None)):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
            for k, v in batch.items()}


class _PlanTap15:
    """Every routing plan (expert, slot, valid) computed, as numpy, with
    the router probabilities and capacity it was computed from."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.real, self.plans = moe_mod, \
            moe_mod.route_with_bulk_steal, []
        moe_mod.route_with_bulk_steal = self

    def __call__(self, probs, top_k, capacity, bulk_steal=True):
        out = self.real(probs, top_k, capacity, bulk_steal=bulk_steal)
        self.plans.append({"plan": [out[i].cpu().numpy() for i in (0, 1, 3)],
                           "probs": probs.float().cpu().numpy(),
                           "top_k": top_k, "capacity": capacity,
                           "bulk_steal": bulk_steal})
        return out

    def close(self):
        self.mod.route_with_bulk_steal = self.real


class _GradTap15:
    """The gradients the next train step hands AdamW (the trainer's
    ``adamw_update``, wrapped once)."""

    def __init__(self):
        from repro_torch.train import trainer
        self.mod, self.real, self.grads = trainer, trainer.adamw_update, None
        trainer.adamw_update = self

    def __call__(self, cfg, grads, *a, **kw):
        self.grads = grads
        self.mod.adamw_update = self.real
        return self.real(cfg, grads, *a, **kw)


def plan_check(ranks_plans, ref_plans) -> dict:
    """The sharded routing against the unsharded dispatch's.  Gated:
    every plan a rank made is the unsharded dispatch's plan of the same
    router probabilities (``route_with_bulk_steal`` over the whole global
    chunk at its capacity).  Reported: how far the unsharded forward's
    own plans agree, and the largest gap at a token's top-k boundary (in
    the unsharded probabilities) among the tokens whose experts differ:
    a gap near float32 rounding means the two forwards' router inputs
    rounded apart at a near-tie, not that the dispatch differs."""
    import torch
    from repro_torch.models.moe import route_with_bulk_steal
    same = True
    for plans in ranks_plans:
        same &= len(plans) == len(ref_plans)
        for got in plans:
            want = route_with_bulk_steal(
                torch.from_numpy(got["probs"]), got["top_k"],
                got["capacity"], bulk_steal=got["bulk_steal"])
            same &= all(np.array_equal(a, want[i].numpy())
                        for a, i in zip(got["plan"], (0, 1, 3)))
    equal = total = 0
    gap = 0.0
    for got, want in zip(ranks_plans[0], ref_plans):
        k = want["top_k"]
        for a, b in zip(got["plan"], want["plan"]):
            equal += int((a == b).sum())
            total += a.size
        srt = -np.sort(-want["probs"], axis=1)
        ours = np.sort(np.argsort(-got["probs"], axis=1, kind="stable")
                       [:, :k], axis=1)
        theirs = np.sort(np.argsort(-want["probs"], axis=1, kind="stable")
                         [:, :k], axis=1)
        flipped = np.any(ours != theirs, axis=1)
        if flipped.any():
            gap = max(gap, float((srt[flipped, k - 1]
                                  - srt[flipped, k]).max()))
    return {"plans_bit_equal": bool(same),
            "forward_plan_agreement": equal / max(total, 1),
            "flipped_tokens_max_topk_gap": gap}


def step15_reference(device, c, *, reduced: bool) -> dict:
    """The unsharded reference of one case on ``device``: the first
    batch's loss and gradient, the losses and ms of ``c["steps"]`` AdamW
    steps, a prefill's logits and the MoE's routing plans; the gradient
    stays on the device for the ranks (the parameters they make from the
    seed themselves)."""
    import torch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step, value_and_grad
    model = _step15_model(c, reduced=reduced)
    params = model.init(torch.Generator(device=device).manual_seed(
        c["seed"]))
    batches = _step15_batches(model.cfg, c)
    first = _tensors15(batches[0], device)
    loss, grads = value_and_grad(model.loss_fn, params, first)
    out = {"loss0": float(loss), "grads": grads, "batches": batches}
    step = make_train_step(model, AdamWConfig(**c["opt"]))
    state, p = adamw_init(params), params
    out.update(losses=[], grad_norms=[], ms=[])
    for b in batches:
        b = _tensors15(b, device)
        sync(device)
        t = time.perf_counter()
        p, state, met = step(p, state, b)
        sync(device)
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
    del p, state
    with torch.no_grad():
        if c.get("prefill"):
            logits, _ = model.prefill(params, first["tokens"])
            out["logits"] = logits.float().cpu().numpy()
        if model.cfg.n_experts:
            tap = _PlanTap15()
            try:
                model.loss_fn(params, first)
            finally:
                tap.close()
            out["plans"] = tap.plans
    return out


def _step15_case(mesh, device, c, ref, *, reduced: bool,
                 record: bool = False) -> dict:
    """One case on this rank: its parameter blocks made from the seed
    (the ranks take turns, one whole tree on the card at a time); the
    prefill and the routing plans; then the sharded steps, the first
    one's gradient blocks (handed to AdamW) against the reference's."""
    import torch
    from repro_torch._tree import tree_leaves_with_path
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step
    model = _step15_model(c, reduced=reduced, pods="pod" in mesh.shape)
    specs = model.param_specs()
    local = None
    t0 = time.perf_counter()
    for turn in range(int(np.prod(list(mesh.shape.values())))):
        if turn == mesh.rank:
            full = model.init(torch.Generator(device=device).manual_seed(
                c["seed"]))
            local = mesh.shard(full, specs)
            del full
            if device.type == "cuda":
                torch.cuda.empty_cache()
        mesh.barrier()
    entry = tuple(a for a in model.sh.dp if a in mesh.shape)
    n, i = mesh.size(entry), mesh.index(entry)
    rows = slice(i * c["batch"] // n, (i + 1) * c["batch"] // n)
    out = {"init_s": time.perf_counter() - t0}
    first = _tensors15(ref["batches"][0], device, rows)
    with torch.no_grad():
        if "logits" in ref:
            counts = flash.mha.launches
            with mesh.spmd():
                logits, _ = model.prefill(local, first["tokens"])
            out["prefill_launches"] = flash.mha.launches - counts
            out["logits_max_abs_err"] = float(np.abs(
                logits.float().cpu().numpy() - ref["logits"][rows]).max())
            del logits
        if "plans" in ref:
            tap = _PlanTap15()
            try:
                with mesh.spmd():
                    model.loss_fn(local, first)
            finally:
                tap.close()
            out["plans"] = tap.plans
    step = make_train_step(model, AdamWConfig(**c["opt"]))
    state, p = adamw_init(local), local
    del local
    out.update(losses=[], grad_norms=[], ms=[], launches=[])
    for k, b in enumerate(ref["batches"]):
        b = _tensors15(b, device, rows)
        counts = (flash.mha.launches, ssd_ops.ssd.launches)
        if k == 0:
            gc.collect()
            _reset_peak(device)
            log = mesh.record() if record else None
            tap = _GradTap15()
        sync(device)
        t = time.perf_counter()
        with mesh.spmd():
            p, state, met = step(p, state, b)
        sync(device)
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append(float(met["loss"]))
        out["grad_norms"].append(float(met["grad_norm"]))
        out["launches"].append({
            "flash_attention": flash.mha.launches - counts[0],
            "ssd_scan": ssd_ops.ssd.launches - counts[1]})
        if k == 0:
            out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                 if device.type == "cuda" else None)
            if record:
                out["log"] = list(log)
                mesh.log = None
                for lanes in mesh.lanes.values():
                    lanes.log = None
            worst = {}
            for key, g in tree_leaves_with_path(tap.grads):
                path, shape = ref["grads"][key]
                full = torch.from_file(path, shared=True,
                                       size=int(np.prod(shape)),
                                       dtype=torch.float32).view(shape)
                want = mesh.shard(full, None if g.shape == full.shape
                                  else _leaf_spec(specs, key))
                worst[key] = float((g.float() - want.to(g.device).float())
                                   .abs().max()) / max(ref["grad_max"][key],
                                                       1e-30)
                del want, full
            out["max_grad_err_over_leaf_max"] = max(worst.values())
            out["worst_leaf"] = max(worst, key=worst.get)
            del tap
    del p, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _leaf_spec(specs, key: str):
    for part in key.split("/"):
        specs = specs[part]
    return specs


def _step15_rank(rank: int, cfg: dict, names: tuple, device_type: str,
                 refs_path: str, reduced: bool, started: float) -> dict:
    """One rank of phase 15's cases ``names``, each on its mesh (the pod
    mesh for ``pods``), in turn, against the references pickled at
    ``refs_path`` (a spawned rank's arguments travel through a pipe that
    the parent fills one rank at a time: past the pipe's buffer the ranks
    would start one after another); rank 0 reports on stderr the seconds
    since the spawn (``started``, the parent's wall clock) at each
    stage."""
    import pickle
    with open(refs_path, "rb") as f:
        refs = pickle.load(f)

    def mark(what):
        if rank == 0:
            print(f"phase 15: rank 0 {what} at {time.time() - started:.1f}"
                  f" s", file=sys.stderr, flush=True)

    mark("started")
    _port()
    from repro_torch.launch.mesh import make_model_mesh
    device = _rank_device(rank, device_type)
    meshes = {"mesh": make_model_mesh(*cfg["mesh"], device=device)}
    if "pods" in names:
        meshes["pod_mesh"] = make_model_mesh(*cfg["pod_mesh"], device=device)
    mark("meshes made")
    out = {"coords": meshes["mesh"].coords}
    for name in names:
        mesh = meshes["pod_mesh" if name == "pods" else "mesh"]
        out[name] = _step15_case(mesh, device, cfg[name], refs[name],
                                 reduced=reduced, record=name == "dense")
        out[name]["coords"] = mesh.coords
        mark(f"{name} done, steps {[round(m) for m in out[name]['ms']]} ms")
    return out


def phase_sharded_step(device, cfg) -> dict:
    """Phase 15: each case's unsharded reference on the card (its gradient
    written to raw temporary files, one a leaf, which the ranks map and
    cut their blocks from), one spawn of 8 gloo ranks running every case, the gates over
    every rank's results, then the dry run's trace of (a)'s step against
    rank 0's and ``run_cell``."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_recording_mesh, run_workers
    reduced = cfg.get("reduced", False)
    t_phase = time.perf_counter()
    import tempfile
    from repro_torch._tree import tree_leaves_with_path
    # the ranks' allocators: segments that grow, not a cached block each
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    names = ("dense", "pods", "moe", "ssm")
    refs, results = {}, {}
    ref_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_step15_"))
    try:
        # each reference's gradient to a file the ranks map and cut
        # their blocks from (nothing of it stays on the card)
        t0 = time.perf_counter()
        for name in names:
            refs[name] = step15_reference(device, cfg[name],
                                          reduced=reduced)
            grads = refs[name].pop("grads")
            refs[name]["grad_max"], refs[name]["grads"] = {}, {}
            for i, (key, g) in enumerate(tree_leaves_with_path(grads)):
                refs[name]["grad_max"][key] = float(g.abs().max())
                path = str(ref_dir / f"{name}_{i}.f32")
                g.float().cpu().numpy().tofile(path)  # raw, mapped back
                refs[name]["grads"][key] = (path, tuple(g.shape))
            del grads
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        import pickle
        with open(ref_dir / "refs.pkl", "wb") as f:
            pickle.dump(refs, f)
        refs_s = time.perf_counter() - t0
        print(f"phase 15: references in {refs_s:.1f} s", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        ranks = run_workers(functools.partial(
            _step15_rank, cfg=cfg, names=names, device_type=device.type,
            refs_path=str(ref_dir / "refs.pkl"), reduced=reduced,
            started=time.time()),
            int(np.prod(cfg["mesh"][0])), backend="gloo",
            timeout=cfg["timeout"])
        spawn_s = time.perf_counter() - t0
        print(f"phase 15: the cases on {len(ranks)} ranks in "
              f"{spawn_s:.1f} s", file=sys.stderr, flush=True)
    finally:
        import shutil
        shutil.rmtree(ref_dir, ignore_errors=True)
    out = {}
    for name in names:
        results[name] = (refs[name], ranks)
    for name in ("dense", "moe", "ssm", "pods"):
        ref, ranks = results[name]
        c = cfg[name]
        rows = [r[name] for r in ranks]
        model = _step15_model(c, reduced=reduced)
        L = model.cfg.n_layers
        want = ref["losses"]
        kernel = "ssd_scan" if model.cfg.family == "ssm" else \
            "flash_attention"
        per_step = 2 * L if model.cfg.remat else L
        for k, r in enumerate(rows):
            for got, w in zip(r["losses"], want):
                check(abs(got - w) <= SHARDED_LOSS_TOL * (1 + abs(w)),
                      f"{name} rank {k}: sharded loss {got}, unsharded {w}")
            check(r["max_grad_err_over_leaf_max"] <= SHARDED_GRAD_TOL,
                  f"{name} rank {k}: gradient {r['worst_leaf']} "
                  f"{r['max_grad_err_over_leaf_max']} of its largest |g|")
            if device.type == "cuda":
                check(all(n[kernel] == per_step for n in r["launches"]),
                      f"{name} rank {k}: {kernel} launched "
                      f"{r['launches']}, not {per_step} a step")
            if "logits_max_abs_err" in r:
                check(r["logits_max_abs_err"] <= SHARDED_LOGITS_TOL,
                      f"{name} rank {k}: prefill logits "
                      f"{r['logits_max_abs_err']} from the unsharded")

        out[name] = {
            "arch": c["arch"], "layers": L, "batch": c["batch"],
            "seq": c["seq"], "steps": len(want),
            "unsharded_losses": want,
            "unsharded_ms_per_step": ref["ms"][:len(want)],
            "losses": [r["losses"] for r in rows],
            "ms_per_step": [r["ms"] for r in rows],
            "max_grad_err_over_leaf_max": [
                r["max_grad_err_over_leaf_max"] for r in rows],
            "launches_per_step": rows[0]["launches"],
            "kernel_launches_expected_per_step": per_step}
        for key in ("logits_max_abs_err", "prefill_launches", "init_s"):
            if key in rows[0]:
                out[name][key] = [r[key] for r in rows]
        if "plans" in ref:
            plans = plan_check([r["plans"] for r in rows], ref["plans"])
            check(plans["plans_bit_equal"], f"{name}: a rank's routing "
                  f"plan is not the unsharded dispatch's of its router "
                  f"probabilities")
            check(plans["flipped_tokens_max_topk_gap"] <= PLAN_TIE_GAP,
                  f"{name}: a token routed to other experts than the "
                  f"unsharded forward's, {plans} (not a near-tie)")
            out[name].update(plans)
        if c.get("layers"):
            out[name]["reduced"] = (f"depth {L} of "
                                    f"{_arch_cfg(c['arch']).n_layers}")
    out["mesh"] = dict(zip(cfg["mesh"][1], cfg["mesh"][0]))
    out["pod_mesh"] = dict(zip(cfg["pod_mesh"][1], cfg["pod_mesh"][0]))
    out["spawn_wall_s"] = spawn_s
    out["references_s"] = refs_s
    out["transport"] = "gloo, staged through the host"
    out["coords"] = [r["dense"]["coords"] for r in results["dense"][1]]
    out["pod_coords"] = [r["pods"]["coords"] for r in results["dense"][1]]
    ranks = results["dense"][1]
    # (d) the dry run's trace of (a)'s first step against rank 0's
    c = cfg["dense"]
    model = _step15_model(c, reduced=reduced)
    rec = make_recording_mesh(*cfg["mesh"])
    from repro_torch.configs.base import ParallelConfig
    tr = dryrun.trace_cell(model.cfg, ShapeConfig("phase15", c["seq"],
                                                  c["batch"], "train"),
                           rec, ParallelConfig())
    real = [tuple(x) for x in ranks[0]["dense"]["log"]]
    check([tuple(x) for x in tr["records"]] == real,
          f"the dry run's collective log ({len(tr['records'])} calls) is "
          f"not rank 0's ({len(real)})")
    peak = ranks[0]["dense"]["peak_bytes"]
    traced = tr["argument_bytes"] + tr["temp_bytes"]
    out["dry_run_check"] = {
        "collectives": len(real), "log_equal": True,
        "traced_args_plus_temp_bytes": traced,
        "rank0_max_memory_allocated": peak,
        "traced_over_allocated": traced / peak if peak else None,
        "traced_flops": tr["flops"]}
    if cfg.get("run_cell"):
        arch, shape = cfg["run_cell"]
        out["run_cell"] = dryrun.run_cell(arch, shape, multi_pod=False,
                                          verbose=False)
        out["total_memory"] = (torch.cuda.get_device_properties(0)
                               .total_memory if device.type == "cuda"
                               else None)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------- phase 14: observability


def _prom_value(text: str, name: str) -> float:
    """The value of the unlabelled sample ``name`` in Prometheus text."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise KeyError(name)


def phase_obs(device, counters, cfg, expect=None, served=None,
              turns: int = 3) -> dict:
    """Phase 14: phase 8's DAG replays with a phase probe attached, the
    metrics and the trace of the probed runs, ``run_resilient``'s
    textfile, and (``served``: ``(requests served, the ServeCluster's
    metrics)`` from phase 4) the serving metrics; see the module
    docstring."""
    import tempfile

    import torch
    from repro_torch.launch.resilient import run_resilient
    from repro_torch.obs.phase import PHASES
    from repro_torch.obs.trace import export_trace, validate_trace

    t_phase = time.perf_counter()
    out, ms = {}, {}
    for name, plan, pod in (("flat", cfg["flat_plan"], None),
                            ("hier", cfg["hier_plan"], cfg["pod_size"])):
        ms[name] = {"unprobed": [], "probed": []}
        for turn in range(turns):
            # in turns: unprobed first on even turns, probed first on odd
            order = (False, True) if turn % 2 == 0 else (True, False)
            runs = {}
            for probe in order:
                runs[probe] = _replay(device, counters, cfg, plan, pod,
                                      probe=probe)
                rt, _, rounds, _, _, wall = runs[probe]
                ms[name]["probed" if probe else "unprobed"].append(
                    wall * 1e3 / rounds)
            rt, carry, rounds, dispatched, launches, wall = runs[True]
            got = _pins(rt, carry, rounds)
            # (a) bit-identity with the probe on
            want = expect[name] if expect is not None else _pins(
                *(runs[False][i] for i in (0, 1, 2)))
            check(got == want, f"obs {name}: probed pins {got} != {want}")
            # (b) the same launches as the unprobed replay
            check(launches == runs[False][4],
                  f"obs {name}: launches {launches} probed, "
                  f"{runs[False][4]} unprobed")
            # (c) every round measured, none estimated; the fractions sum
            # to 1 and the rounds' time stays inside the drain's wall
            ps = rt.telemetry.phase_summary()
            fractions = {p: ps["phases"][p]["fraction"] for p in PHASES}
            check(ps["timed_rounds"] == rounds
                  and ps["estimated_rounds"] == 0
                  and all(ps["phases"][p]["total_s"] >= 0 for p in PHASES)
                  and abs(sum(fractions.values()) - 1.0) <= 1e-9
                  and ps["wall_s"] <= wall,
                  f"obs {name}: phase summary {ps} over {rounds} rounds "
                  f"in {wall} s")
            # (d) the Prometheus text carries the pinned totals
            text = rt.metrics().to_prometheus()
            summary = want["summary"]
            for metric, key in (("repro_rounds_total", "rounds"),
                                ("repro_steals_total", "steals"),
                                ("repro_items_transferred_total",
                                 "items_transferred")):
                check(_prom_value(text, metric) == summary[key],
                      f"obs {name}: {metric} "
                      f"{_prom_value(text, metric)} != {summary[key]}")
            if turn == 0:
                out[name] = {"rounds": rounds, "dispatched": dispatched,
                             "launches": launches,
                             "phase_fractions": fractions,
                             "phase_ms_per_round": {
                                 p: ps["phases"][p]["mean_s"] * 1e3
                                 for p in PHASES},
                             "attributed_s": ps["wall_s"], "drain_s": wall}
                if name == "flat":
                    # (e) the probed stream's trace is well-formed
                    counts = validate_trace(export_trace(rt.telemetry))
                    check(counts.get("round") == rounds
                          and counts.get("phase") == len(PHASES) * rounds,
                          f"obs: trace counts {counts} for {rounds} rounds")
                    out["trace_counts"] = counts
        med = {k: float(np.median(v)) for k, v in ms[name].items()}
        out[name]["overhead_ratio"] = med["probed"] / med["unprobed"]
    out["ms_per_round"] = ms

    # (f) run_resilient's textfile on the card, rewritten between every
    # block, equals a final poll of the runtime it drove
    with tempfile.TemporaryDirectory() as tmp:
        path, final = str(Path(tmp) / "repro.prom"), {}

        def make_runtime():
            rt = _dag_runtime(device, cfg, cfg["flat_plan"])
            rt.attach_phase_probe()
            return rt

        def drive(rt, should_stop):
            body = dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                            fanout=cfg["fanout"])
            carry = torch.zeros((cfg["lanes"],), dtype=torch.int32,
                                device=device)
            while rt.total_size() > 0 and not should_stop():
                carry, _, _ = rt.run_fused(cfg["block"], body, carry,
                                           until_drained=True)
            final["rt"] = rt
            return rt.rounds_run

        rounds = run_resilient(make_runtime, drive,
                               snapshot_dir=str(Path(tmp) / "snap"),
                               max_restarts=0, metrics_path=path,
                               metrics_every_s=0.0)
        text = Path(path).read_text()
        check(text == final["rt"].metrics().to_prometheus()
              and _prom_value(text, "repro_rounds_total") == rounds,
              "run_resilient's textfile is not the final poll")
        out["textfile"] = {"rounds": rounds, "lines": len(text.splitlines())}

    # (g) the serving cluster's metrics after phase 4
    if served is not None:
        n, snap = served
        got = snap["repro_serve_served_total"]["values"]
        check(got == n, f"repro_serve_served_total {got} != {n} served")
        out["serve_served_total"] = got
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ----------------------------------------------- phase 16: the examples

EXAMPLE_INTS = {
    "quickstart": {
        "steal_n": r"device bulk steal: (\d+) items",
        "queue_launches": r"queue kernel launches: ring_gather=(\d+) "
                          r"ring_scatter=(\d+) ring_transfer=(\d+)",
        "moved": r"superstep moved (\d+) items in (\d+) steals",
        "superstep_launches": r"superstep kernel launches: ring_gather="
                              r"(\d+) ring_scatter=(\d+) ring_transfer="
                              r"(\d+)",
        "sizes": r"sizes before: \[([\d, ]+)\] after one master "
                 r"superstep: \[([\d, ]+)\]"},
    "knapsack_solver": {
        "paper_optimum": r"DD branch-and-bound optimum: (\d+)",
        "oracle": r"DP oracle=(\d+)", "sequential": r"sequential=(\d+)",
        "parallel": r"parallel=(\d+)", "supersteps": r"(\d+) supersteps",
        "steals": r"runtime telemetry: (\d+) steals"},
    "serve_demo": {
        "served": r"\[serve_demo\] (\d+)/(\d+) requests",
        "stolen": r"master bulk-stole (\d+) requests over (\d+) rounds",
        "completed": r"per-replica completed: \[([\d, ]+)\]",
        "flash_attention": r"flash-attention kernel launches: (\d+)"},
    "train_lm": {
        "losses": r"step +\d+ +loss ([\d.]+)",
        "flash_attention": r"flash-attention kernel launches: (\d+)"},
}


def _example_ints(name: str, out: str) -> dict:
    """The integers (and the losses) an example printed, by
    :data:`EXAMPLE_INTS`; a pattern it did not print fails the phase."""
    import re
    got = {}
    for key, pat in EXAMPLE_INTS[name].items():
        hits = re.findall(pat, out)
        check(bool(hits), f"example {name} printed no {key!r} line:\n{out}")
        groups = [g for h in hits
                  for g in (h if isinstance(h, tuple) else (h,))]
        nums = [float(x) if "." in x else int(x)
                for g in groups for x in re.split(r"[,\s]+", g) if x]
        got[key] = nums if key == "losses" or len(nums) > 1 else nums[0]
    return got


def run_example(name: str, args, device, timeout: float) -> dict:
    """``examples/torch_<name>.py`` in a subprocess on ``device``: its exit
    code, wall seconds, and the integers it printed (the run's output on
    failure)."""
    import shutil
    import tempfile
    argv = [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
            "--device", device.type, *args]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
    if name == "train_lm":  # a fresh checkpoint directory: no resume
        argv += ["--ckpt-dir", tmp]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get(
            "PYTHONPATH", "").split(os.pathsep) if p]))
    if device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # beside other test processes
    t0 = time.perf_counter()
    try:
        res = subprocess.run(argv, cwd=str(ROOT), env=env, timeout=timeout,
                             capture_output=True, text=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"example {name} exited {res.returncode}:\n"
          f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return dict(rc=res.returncode, wall_s=wall,
                ints=_example_ints(name, res.stdout))


def phase_examples(device, cfg) -> dict:
    """Phase 16: the four examples of the port in turn, each a subprocess
    on ``device`` with ``cfg``'s arguments, held to their own results:
    the knapsack optimum equal to the DP oracle's (sequential and
    parallel), every request served and some stolen, the superstep
    conserving the items, the loss falling; on the card, each example's
    kernels launched (K2 and K1 by the quickstart's queue, K1 and K4 by
    its superstep, K6 by the serving demo and the trainer)."""
    t0 = time.perf_counter()
    out = {}
    for name in ("quickstart", "knapsack_solver", "serve_demo", "train_lm"):
        out[name] = run_example(name, cfg[name], device, cfg["timeout"])
    q, k, s, t = (out[n]["ints"] for n in ("quickstart", "knapsack_solver",
                                            "serve_demo", "train_lm"))
    before, after = q["sizes"][:4], q["sizes"][4:]
    check(sum(before) == sum(after) and q["moved"][0] > 0,
          f"quickstart superstep: {before} -> {after}, moved {q['moved']}")
    check(k["oracle"] == k["sequential"] == k["parallel"],
          f"knapsack: oracle {k['oracle']}, sequential {k['sequential']}, "
          f"parallel {k['parallel']}")
    check(k["paper_optimum"] == 15, f"paper example optimum "
          f"{k['paper_optimum']} != 15")
    served, requests = s["served"]
    check(served == requests and sum(s["completed"]) == requests,
          f"serve demo served {served} of {requests}")
    check(s["stolen"][0] > 0, "serve demo: the master stole nothing")
    check(t["losses"][-1] < t["losses"][0],
          f"train_lm: the loss did not fall: {t['losses']}")
    if device.type == "cuda":
        g, sc, _ = q["queue_launches"]
        check(g > 0 and sc > 0, f"quickstart queue launched K1 {g} / K2 "
              f"{sc} times")
        g, _, tr = q["superstep_launches"]
        check(g > 0 and tr > 0, f"quickstart superstep launched K1 {g} / "
              f"K4 {tr} times")
        check(s["flash_attention"] > 0 and t["flash_attention"] > 0,
              f"K6 launched {s['flash_attention']} / {t['flash_attention']} "
              f"times in the serving demo / the trainer")
    return dict(examples=out, wall_s=time.perf_counter() - t0)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    lib, counters = _port()
    from repro_torch.configs.paper_lfq import CONFIG

    device = torch.device("cuda")
    t0 = time.perf_counter()
    lib.library()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"built {len(lib.SOURCES)} sources in {build_s:.1f} s; card: {card}",
          flush=True)

    kernels = phase_kernels(device)
    print(json.dumps({"phase": "kernels", "result": kernels}), flush=True)
    fig6 = push_latency(device, np.random.default_rng(1), Timer(device))
    print(json.dumps({"phase": "push_latency", "result": fig6}), flush=True)
    queue = phase_queue(device, lanes=LANES, capacity=CONFIG.queue_capacity,
                        backlog=CONFIG.bench_initial_size,
                        max_steal=CONFIG.max_steal, rounds=8)
    print(json.dumps({"phase": "queue", "result": queue}), flush=True)
    solver = phase_solver(device, counters, expect=PHASE3_EXPECT,
                          off_path=_off_path(), **PHASE3)
    print(json.dumps({"phase": "solver", "result": solver}), flush=True)
    # each worker body: one pop (one K3 launch for the payload tree) and
    # one fused explore
    n = solver["launches"]
    check(n["dd_expand"] == n["ring_slice"],
          f"the fused explore launched {n['dd_expand']} times and K3 "
          f"{n['ring_slice']}, not once each per worker body")
    # one K2 launch per push of the payload tree: the runtime's seed push
    # and one push per worker body
    check(n["ring_scatter"] == n["ring_slice"] + 1,
          f"K2 launched {n['ring_scatter']} times for {n['ring_slice'] + 1} "
          f"pushes, not once per push")
    sequential = phase_sequential(device, counters["dd_expand"],
                                  expect=PHASE3B_EXPECT, **PHASE3B)
    print(json.dumps({"phase": "solver_sequential", "result": sequential}),
          flush=True)
    checkers = phase_checkers(device, counters, lanes=LANES,
                              capacity=CONFIG.queue_capacity,
                              backlog=CONFIG.bench_initial_size,
                              max_steal=CONFIG.max_steal, rounds=8)
    print(json.dumps({"phase": "checkers", "card": card,
                      "result": checkers}), flush=True)
    resilience = phase_resilience(device, counters, PHASE8,
                                  expect=PHASE8_EXPECT)
    print(json.dumps({"phase": "resilience", "card": card,
                      "result": resilience}), flush=True)
    mesh = phase_mesh(device, counters, PHASE9, expect=PHASE9_EXPECT)
    print(json.dumps({"phase": "mesh", "card": card, "result": mesh}),
          flush=True)
    from repro_torch import configs
    serving, serve_metrics = {}, []
    for phase, fn, kw in (("serve", phase_serve, PHASE4),
                          ("serve_ssm", phase_serve, PHASE5),
                          ("wave_hybrid", phase_wave, PHASE6)):
        kw = dict(kw)
        if phase == "serve":  # phase 14 (g) reads the cluster's metrics
            kw["poll"] = lambda c: serve_metrics.append(c.metrics())
        serving[phase] = fn(device, cfg=configs.get(kw.pop("arch")), **kw)
        print(json.dumps({"phase": phase, "result": serving[phase]}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()  # the next phase's model is larger

    decode = phase_decode(device, counters, PHASE10, expect=PHASE10_EXPECT)
    print(json.dumps({"phase": "decode", "card": card, "result": decode}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(device, PHASE11)
    print(json.dumps({"phase": "train", "card": card, "result": train}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    encdec = phase_encdec(device, PHASE12)
    print(json.dumps({"phase": "encdec", "card": card, "result": encdec}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase_sharded(device, PHASE13)
    print(json.dumps({"phase": "sharded", "card": card, "result": sharded}),
          flush=True)
    obs = phase_obs(device, counters, PHASE8, expect=PHASE8_EXPECT,
                    served=(serving["serve"]["requests"],
                            serve_metrics[0].snapshot()))
    print(json.dumps({"phase": "obs", "card": card, "result": obs}),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    sharded_step = phase_sharded_step(device, PHASE15)
    print(json.dumps({"phase": "sharded_step", "card": card,
                      "result": sharded_step}), flush=True)

    examples = phase_examples(device, PHASE16)
    print(json.dumps({"phase": "examples", "card": card,
                      "result": examples}), flush=True)

    launches = {**solver["launches"],
                "flash_attention": serving["serve"]["launches"][
                    "flash_attention"],
                "flash_attention_hd112": serving["wave_hybrid"]["launches"][
                    "flash_attention"],
                "flash_attention_cross": encdec["serve"]["launches_by_mode"][
                    "cross"],
                "ssd_scan": serving["serve_ssm"]["launches"]["ssd_scan"],
                "ssd_scan_hd64_ns64": serving["wave_hybrid"]["launches"][
                    "ssd_scan"]}
    for name in (n for n, _, _ in KERNELS):
        check(launches[name] > 0, f"{name} never launched on its path")
    rows = []
    for name, source, replaces in KERNELS:
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "parity_cases": k["parity_cases"], "timed_at": k["timed_at"],
            "device_time_clean": k["device_time_clean"],
            **{key: k[key] for key in ("earlier_ms", "earlier",
                                       "launches_per_call", "bound_ops",
                                       "plain_device_time_clean",
                                       "solver_payload") if key in k}})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
