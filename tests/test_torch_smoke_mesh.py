"""``chip_smoke.py``'s phases that spawn ranks, rehearsed on the CPU at a
small size: the mesh phase (9) on gloo CPU ranks against
``scripts/mesh_pins.py``'s pins, the sharded-model bodies (13) and the
sharded step (15) on 8 gloo CPU ranks against the unsharded ones.  The
other phases' rehearsals are in ``tests/test_torch_smoke.py``; on the card
the script runs the same code at full size."""

import importlib
import importlib.util
from pathlib import Path

import torch

from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def test_mesh_phase_matches_the_pins_script_at_a_cpu_size(monkeypatch):
    """Phase 9 at ``PHASE9_SMALL`` on 4 gloo CPU ranks: the mesh solver
    held to what ``scripts/mesh_pins.py`` computes from the JAX package at
    that size and to the stacked runtime, the backlog's digests to the
    stacked runtime's, and (c) on one gloo rank (the card's run is held to
    the same script's full-size run, pinned in ``PHASE9_EXPECT``)."""
    # the ranks import chip_smoke by name, from the path they inherit
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    spec = importlib.util.spec_from_file_location(
        "mesh_pins", ROOT / "scripts" / "mesh_pins.py")
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    cfg = smoke.PHASE9_SMALL
    expect = pins.pins(cfg["solver"])
    _, counters = smoke._port()
    out = smoke.phase_mesh(CPU, counters, cfg, expect=expect)
    assert out["solver"]["supersteps"] == expect["supersteps"] > 8
    assert out["solver"]["transferred"] > 0
    assert set(out["backlog"]) == {"flat/compact", "flat/dense",
                                   "pods/compact", "pods/dense"}
    assert all(b["transport"] == "gloo, staged through the host"
               for b in out["backlog"].values())
    assert out["single"]["supersteps"] > 1
    # the card's pins come from the same script at PHASE9's size
    assert set(smoke.PHASE9_EXPECT) == set(expect)


def test_sharded_phase_holds_every_gate_at_a_cpu_size(monkeypatch):
    """Phase 13 at ``PHASE13_SMALL``: 8 gloo CPU ranks as a (data 2, model
    4) mesh; flash-decoding within its tolerances of the unsharded decode
    on every rank (model ranks 2 and 3 start with 5 and 0 valid slots),
    and expert-parallel prefill with bit-equal plans."""
    # the ranks import chip_smoke by name, from the path they inherit
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    out = smoke.phase_sharded(CPU, smoke.PHASE13_SMALL)
    assert out["mesh"] == {"data": 2, "model": 4}
    for name in ("flash", "flash_f32"):
        assert all(x <= 1.0 for x in out[name]["max_err_over_tol"])
        assert out[name]["flash_decode_calls"] == [12] * 8  # 3 steps x 4
        assert out[name]["valid_slots_at_first_step"] == [10, 10, 5, 0] * 2
    assert out["moe"]["experts_held"] == [2] * 8
    assert out["moe"]["ep_calls"] == [4] * 8
    assert all(out["moe"]["plans_bit_equal"])


def test_sharded_step_phase_holds_every_gate_at_a_cpu_size(monkeypatch):
    """Phase 15 at ``PHASE15_SMALL``: 8 gloo CPU ranks; the sharded train
    steps of reduced llama3.2-1b (two), qwen3-moe and mamba2 within the
    phase's tolerances of the unsharded ones on every rank, a prefill's
    logits, the MoE's plans bit-equal, llama on the (pod 2, data 2, model
    2) mesh, and the dry run's trace of the llama step logging rank 0's
    collectives call for call."""
    monkeypatch.syspath_prepend(str(ROOT))
    smoke = importlib.import_module("chip_smoke")
    out = smoke.phase_sharded_step(CPU, smoke.PHASE15_SMALL)
    assert out["mesh"] == {"data": 2, "model": 4}
    assert out["pod_mesh"] == {"pod": 2, "data": 2, "model": 2}
    for name, steps in (("dense", 2), ("moe", 1), ("ssm", 1), ("pods", 1)):
        assert len(out[name]["losses"]) == 8
        assert all(len(x) == steps for x in out[name]["losses"])
        assert max(out[name]["max_grad_err_over_leaf_max"]) <= \
            smoke.SHARDED_GRAD_TOL
    assert max(out["dense"]["logits_max_abs_err"]) <= \
        smoke.SHARDED_LOGITS_TOL
    assert out["moe"]["plans_bit_equal"]
    assert out["moe"]["forward_plan_agreement"] == 1.0
    check = out["dry_run_check"]
    assert check["log_equal"] and check["collectives"] > 0
