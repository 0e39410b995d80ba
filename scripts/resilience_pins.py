#!/usr/bin/env python3
"""The JAX package's results for ``chip_smoke.py``'s resilience phase,
computed on the CPU — the integers the phase pins and holds the port to.

Runs ``repro.runtime.StealRuntime`` (the JAX package, vmapped lanes, its
``reference`` routing) on the Fig. 9 DAG of ``tests/test_resilience.py``
drained with ``run_fused(block, until_drained=True)``: (a) flat under a
kill / delay / drop plan and (b) in pods with a dead lane and a dead
pod, and prints one JSON object per configuration: the round count, the
telemetry summary, the per-lane carry, the final sizes, and SHA-256
digests of the proportion history (float32 bits), the rings and the
``lo`` cursors.  Needs JAX, so it runs here, not on the card::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/resilience_pins.py

``--small`` runs the CPU rehearsal's size instead of the card's.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py``'s configuration (its constants only; it imports
    no framework at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def jax_dag_body(ops, *, n_nodes, pop, fanout):
    import jax.numpy as jnp
    from jax import lax

    def body(q, carry):
        q, nodes, n_popped = ops.pop_bulk(q, pop, jnp.int32(pop))
        valid = jnp.arange(pop, dtype=jnp.int32) < n_popped
        kids = (nodes[:, None] * fanout + 1
                + jnp.arange(fanout, dtype=jnp.int32)[None, :])
        live = valid[:, None] & (kids < n_nodes)
        flat, flive = kids.reshape(-1), live.reshape(-1)
        order = jnp.argsort(~flive, stable=True)
        flat = jnp.where(flive[order], flat[order], 0)
        q, _ = ops.push(q, flat, jnp.sum(flive.astype(jnp.int32)))
        peak = lax.pmax(carry, "workers")
        return q, carry + jnp.sum(valid.astype(jnp.int32)) + 0 * peak
    return body


def pins(cfg: dict, plan: dict, pod_size=None) -> dict:
    """One configuration's results from the JAX package."""
    import jax
    import jax.numpy as jnp

    from repro.core.policy import StealPolicy
    from repro.runtime import FaultPlan, StealRuntime

    lanes = cfg["lanes"]
    rt = StealRuntime(lanes, cfg["capacity"],
                      jax.ShapeDtypeStruct((), jnp.int32),
                      policy=StealPolicy(backend="reference",
                                         max_steal=cfg["max_steal"],
                                         **cfg["policy"]),
                      pod_size=pod_size,
                      fault_plan=None if plan is None else FaultPlan(**plan))
    rt.push(0, jnp.zeros((1,), jnp.int32), 1)
    body = jax_dag_body(rt.ops, n_nodes=cfg["n_nodes"], pop=cfg["pop"],
                        fanout=cfg["fanout"])
    carry, rounds = jnp.zeros((lanes,), jnp.int32), 0
    while rt.total_size() > 0 and rounds < 10_000:
        carry, _, r = rt.run_fused(cfg["block"], body, carry,
                                   until_drained=True)
        rounds += r
    q = jax.tree_util.tree_map(np.asarray, rt.queues)
    return {"rounds": rounds,
            "summary": rt.telemetry.summary(),
            "carry": np.asarray(carry).tolist(),
            "sizes": np.asarray(q.size).tolist(),
            "history": digest(np.asarray(rt.controller.history, np.float32)),
            "history_len": len(rt.controller.history),
            "rings": digest(q.buf),
            "lo": digest(q.lo)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="the CPU rehearsal's size (PHASE8_SMALL)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    smoke = _smoke()
    cfg = smoke.PHASE8_SMALL if args.small else smoke.PHASE8
    out = {"jax": jax.__version__, "config": "small" if args.small
           else "card"}
    for name, plan, pod in (("flat", cfg["flat_plan"], None),
                            ("hier", cfg["hier_plan"], cfg["pod_size"])):
        t0 = time.perf_counter()
        out[name] = pins(cfg, plan, pod)
        out[name]["cpu_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
