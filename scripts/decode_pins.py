#!/usr/bin/env python3
"""The JAX package's results for ``chip_smoke.py``'s decode phase (phase
10), computed on the CPU — the integers the phase pins as
``PHASE10_EXPECT`` and holds the port's ``DecodeCluster`` to.

Drains phase 10's request mix through ``repro.serve.decode.DecodeCluster``
(the JAX package's) in each of ``PHASE10_RUNS`` — steal-balanced on
vmapped lanes and on the host master, the static round-robin baseline,
in-flight migration — and prints one JSON object: per run the rounds,
items stolen, migrations, stalls and a digest of every request's (rid,
admit, first, finish) stamps.  These read no model output (they depend on
the mix, the policy and the token loads), so reduced llama3.2-1b gives the
card's integers.  Needs JAX, so it runs here, not on the card::

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/decode_pins.py
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py``'s configuration and its framework-free drive
    helpers (it imports no framework at module level)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pins(smoke, cfg: dict) -> dict:
    """Each of ``PHASE10_RUNS`` through the JAX package's DecodeCluster."""
    import jax

    from repro import configs
    from repro.models import build_model
    from repro.serve.decode import DecodeCluster, DecodePolicy
    from repro.serve.scheduler import Request

    model = build_model(configs.reduced(configs.get(cfg["arch"])))
    params = model.init(jax.random.PRNGKey(cfg["seed"]))
    out = {}
    for name, run in smoke.PHASE10_RUNS:
        run = dict(run)
        pol = DecodePolicy(steal=run.pop("steal", "queue"), **cfg["policy"])
        cluster = DecodeCluster(model, params, policy=pol,
                                n_lanes=cfg["n_lanes"],
                                capacity=cfg["capacity"],
                                straggler_threshold=float("inf"), **run)
        smoke.drive_decode(cluster, smoke.decode_requests(Request, cfg),
                           cfg["arrival"])
        out[name] = smoke.decode_integers(cluster)
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax

    smoke = _smoke()
    t0 = time.perf_counter()
    out = pins(smoke, smoke.PHASE10)
    print(json.dumps({"jax": jax.__version__,
                      "cpu_s": round(time.perf_counter() - t0, 1), **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
