"""The port's continuous-batching decode (``repro_torch.serve.decode``)
against the JAX package on the CPU (the engine's own tests and the
device-resident admission are in ``tests/test_torch_decode_engine.py``).

* ``DecodeCluster`` on ``benchmarks/serve_decode.py``'s tiny cells (28
  requests, W = 4; static round-robin, steal-balanced, steal + migrate on
  stacked lanes, steal-balanced on the host master) in both packages, with
  the JAX package's parameters carried over by ``params_from_numpy`` and
  the wall-clock straggler monitor off on both sides: every request's
  tokens and SLO stamps, the order requests finish in, and ``rounds``,
  ``stolen``, ``migrated`` and ``stalls`` must be equal.
* Phase 10 of ``chip_smoke.py`` at reduced width in float32 against its
  pins (``PHASE10_EXPECT``, computed from the JAX package by
  ``scripts/decode_pins.py``).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro.serve.decode import DecodeCluster as JaxCluster
from repro.serve.decode import DecodePolicy as JaxPolicy
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.serve.decode import DecodeCluster, DecodePolicy
from repro_torch.serve.scheduler import Request

from _torch_decode import INF, models  # noqa: F401
from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------- serve_decode.py's tiny cells

TINY = dict(n_requests=28, arrival=7, seed=0, capacity=128,
            policy=dict(n_slots=4, max_prompt=8, max_new=8, page_size=4))
CELLS = [("rr", "vmap"), ("balanced", "vmap"), ("migrate", "vmap"),
         ("balanced", "host")]


def _cell(cluster_cls, policy_cls, request_cls, model, params, mode,
          execution, **kw):
    smoke = _chip_smoke()
    pol = policy_cls(steal="migrate" if mode == "migrate" else "queue",
                     **TINY["policy"])
    balanced = mode in ("balanced", "migrate")
    c = cluster_cls(model, params, policy=pol, n_lanes=4,
                    capacity=TINY["capacity"], execution=execution,
                    balance=balanced, admission="load" if balanced else "rr",
                    straggler_threshold=INF, **kw)
    reqs = smoke.decode_requests(request_cls, TINY)
    smoke.drive_decode(c, reqs, TINY["arrival"])
    return dict(
        outputs={r.rid: list(r.output) for r in c.done},
        order=[r.rid for r in c.done],
        stamps=[(r.rid, r.admit, r.first, r.finish, r.tokens)
                for r in c.telemetry.requests],
        waves=[(list(map(int, w.loads)), w.served, w.tokens, w.migrated)
               for w in c.telemetry.waves],
        **{k: int(getattr(c, k)) for k in ("rounds", "stolen", "migrated")},
        stalls=c.stats()["stalls"])


@pytest.mark.parametrize("mode,execution", CELLS,
                         ids=[f"{m}-{e}" for m, e in CELLS])
def test_tiny_cells_match_the_jax_package(models, mode, execution):
    jm, tm, jp, tp = models
    want = _cell(JaxCluster, JaxPolicy, JaxRequest, jm, jp, mode, execution)
    got = _cell(DecodeCluster, DecodePolicy, Request, tm, tp, mode,
                execution, device="cpu")
    assert len(got["outputs"]) == TINY["n_requests"]
    for key in ("rounds", "stolen", "migrated", "stalls", "order", "stamps",
                "waves", "outputs"):
        assert got[key] == want[key], key
    if mode == "migrate":
        assert got["migrated"] > 0
    if mode == "rr":
        assert got["stolen"] == 0


# ---------------------------------------------------- chip_smoke's phase 10


def test_phase10_at_reduced_width_matches_its_pins():
    """Phase 10's mix, policy and four runs on reduced llama3.2-1b in
    float32: the scheduling integers read no model output, so they equal
    the pins the card's run is held to (``scripts/decode_pins.py``); every
    token of the reference runs passes the scalar-path check, and a wrong
    token does not."""
    smoke = _chip_smoke()
    _, counters = smoke._port()
    out = smoke.phase_decode(CPU, counters, smoke.PHASE10_SMALL,
                             expect=smoke.PHASE10_EXPECT)
    assert set(out["runs"]) == set(smoke.PHASE10_EXPECT) == {
        name for name, _ in smoke.PHASE10_RUNS}
    for name, res in out["runs"].items():
        assert res["tokens"] == sum(
            m for _, m in smoke.decode_mix(64, 0, 64, 16)), name
        assert set(res["launches"].values()) == {0}   # plain versions here
    assert out["multiset_vmap_eq_host"]
    ref = out["float32_reference"]
    assert ref["runs"] == list(smoke.PHASE10_REFERENCE)
    assert ref["tokens"] == sum(out["runs"][n]["tokens"]
                                for n in ref["runs"])
    assert ref["max_gap_over_tol"] <= 1.0

    model, params = smoke._decode_model(smoke.PHASE10_SMALL, CPU)
    prompt, good = [5, 9, 2], []
    for _ in range(3):          # a greedy decode, one token at a time
        logits = smoke.scalar_decode_logits(model, params, prompt,
                                            good + [0], 16, CPU)
        good.append(int(logits[-1].argmax()))
    smoke.decode_reference(model, params, {"r": {"served": [(
        prompt, good)]}}, 16, CPU)
    bad = good[:2] + [int(logits[-1].argmin())]
    with pytest.raises(AssertionError, match="greedy logit"):
        smoke.decode_reference(model, params, {"r": {"served": [(
            prompt, bad)]}}, 16, CPU)
