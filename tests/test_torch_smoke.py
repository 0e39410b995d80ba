"""``chip_smoke.py``'s phases, rehearsed on the CPU at a small size: the
kernel checks (there the wrappers run the plain versions), the backlog
supersteps across backends and exchanges, the solver phase against the
JAX package's results for the same configuration, the mesh phase on gloo
CPU ranks against the same script's pins, and the serving phases
on reduced llama3.2-1b, mamba2-2.7b and zamba2-7b.  On the card the
script runs the same code at full size."""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.dd.knapsack import random_instance as jax_random_instance
from repro.core.dd.parallel import parallel_solve as jax_parallel_solve
from repro.core.policy import StealPolicy as JaxPolicy
from repro_torch.kernels import cases as C

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# K6 and K7 timed at CPU-sized shapes (the card times the serving
# slices' and zamba2-7b's: K6 at head dim 112, K7 at state width 64).
FLASH_SMALL = (2, 128, 128, 4, 2, 32, True, None, None, "bfloat16")
FLASH_SMALL_112 = (2, 128, 128, 4, 4, 112, True, None, None, "bfloat16")
FLASH_SMALL_CROSS = (2, 64, 100, 4, 4, 64, False, None, None, "bfloat16")
SSD_SMALL = (2, 100, 4, 16, 32, 32, "bfloat16")
SSD_SMALL_64 = (1, 130, 3, 64, 64, 64, "bfloat16")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_phase_checks_every_kernel():
    smoke = _chip_smoke()
    out = smoke.phase_kernels(
        CPU, flash_shapes=(FLASH_SMALL, FLASH_SMALL_112, FLASH_SMALL_CROSS),
        ssd_shapes=(SSD_SMALL, SSD_SMALL_64))
    assert set(out) == {name for name, _, _ in smoke.KERNELS}
    for name, row in out.items():
        assert row["max_abs_err"] == 0.0 and row["parity_cases"] >= 9, name
        assert row["bound_ms"] > 0
        # no single PyTorch call computes K5's or K7's function
        if name in ("dd_expand", "ssd_scan", "ssd_scan_hd64_ns64"):
            assert row["library_ms"] is None, name
        else:
            assert row["library_ms"] > 0, name
    flash_rows = ("flash_attention", "flash_attention_hd112",
                  "flash_attention_cross")
    for name in flash_rows:
        assert out[name]["parity_cases"] == (
            len(C.FLASH_CASES + C.FLASH_EXTRA_CASES + C.FLASH_RAGGED_CASES)
            + len(flash_rows))
        assert out[name]["bound_by"] == "bytes"  # at this tiny size
        assert out[name]["earlier_ms"] > 0
    # the fused explore on its case table, K5 per layer (its earlier
    # design, timed beside it) on its 12 cases
    assert out["dd_expand"]["parity_cases"] == len(C.EXPLORE_CASES) + 12
    assert out["dd_expand"]["bound_ops"] > 0
    for name in ("ssd_scan", "ssd_scan_hd64_ns64"):
        # the tables, their bfloat16 copies, two shapes in two dtypes
        assert out[name]["parity_cases"] == 22
        assert out[name]["earlier_ms"] > 0
        assert out[name]["launches_per_call"] == 0  # none on the CPU
    # K1-K4 also timed as the solver calls them: its three-leaf tree
    for name in ("ring_gather", "ring_scatter", "ring_slice",
                 "ring_transfer"):
        row = out[name]["solver_payload"]
        assert row["bound_ms"] > 0 and row["library_ms"] is None
        assert row["launches_per_call"] == 0  # the CPU launches nothing


def test_push_latency_series_checks_and_times_every_size():
    """The Fig. 6 series at a CPU size: every push size held against the
    plain version and timed beside ``index_copy_`` and its byte bound."""
    smoke = _chip_smoke()
    out = smoke.push_latency(CPU, np.random.default_rng(0),
                             smoke.Timer(CPU), lanes=4, cap=256,
                             sizes=(1, 16, 128))
    assert [row["max_push"] for row in out["series"]] == [1, 16, 128]
    for row in out["series"]:
        assert row["ms"] > 0 and row["library_ms"] > 0
        assert row["bound_bytes"] == 2 * 4 * row["max_push"] * 4 + 2 * 4 * 4


def test_queue_phase_agrees_across_backends_and_conserves():
    smoke = _chip_smoke()
    out = smoke.phase_queue(CPU, lanes=8, capacity=512, backlog=300,
                            max_steal=256, rounds=8)
    assert out["items"] == 4 * 300
    assert out["moved"] == 4 * 150  # every empty lane took half a victim
    assert set(out["ms_per_superstep"]) == {"cuda/compact", "cuda/dense",
                                            "reference/compact"}


def test_checkers_phase_holds_every_check():
    """Phase 7 at a CPU size: the relaxed and the sanitized backlog equal
    to the kernel backend's, the model checker at (4, 2), and the paged
    queue at 8x a 256-row ring."""
    smoke = _chip_smoke()
    _, counters = smoke._port()
    out = smoke.phase_checkers(
        CPU, counters, lanes=8, capacity=512, backlog=300, max_steal=256,
        rounds=8, geometries=((4, 2),),
        paged=dict(capacity=256, n_items=2048, batch=64, pops=200))
    assert set(out["backlog"]["ms_per_superstep"]) == {
        f"{b}/{x}" for b in ("cuda", "relaxed", "cuda+check")
        for x in ("compact", "dense")}
    lin = out["linearize"]
    assert lin["histories"] == {"reference@4,2": 330, "cuda@4,2": 330,
                                "relaxed@4,2": 636}
    assert lin["violations"] == 0 and min(lin["mutations_caught"].values())
    paged = out["paged"]
    assert paged["pops"] + paged["stolen"] == 2048
    assert paged["spills"] > 0 and paged["refills"] > 1


def test_solver_phase_matches_reference():
    smoke = _chip_smoke()
    _, counters = smoke._port()
    cfg = dict(n_items=16, seed=1, n_workers=8, explore_width=8, batch=4,
               capacity=256, max_steal=256)
    opt, st = jax_parallel_solve(
        jax_random_instance(cfg["n_items"], seed=cfg["seed"]),
        n_workers=cfg["n_workers"], explore_width=cfg["explore_width"],
        batch=cfg["batch"], capacity=cfg["capacity"],
        policy=JaxPolicy(proportion=0.5, high_watermark=4, low_watermark=0,
                         max_steal=cfg["max_steal"]))
    expect = dict(optimum=opt, supersteps=st["supersteps"],
                  explored=st["explored"], transferred=st["transferred"],
                  steals=st["telemetry"]["steals"])
    out = smoke.phase_solver(CPU, counters, expect=expect, **cfg)
    assert out["supersteps"] == st["supersteps"]
    assert set(out["launches"]) == {"ring_gather", "ring_scatter",
                                    "ring_slice", "ring_transfer",
                                    "dd_expand"}


def test_sequential_solver_phase_matches_reference():
    """Phase 3b at a CPU size: ``bnb.solve`` against the JAX package's."""
    from repro.core.dd.bnb import solve as jax_solve

    smoke = _chip_smoke()
    cfg = dict(smoke.PHASE3B, n_items=16)
    opt, st = jax_solve(jax_random_instance(16, seed=cfg["seed"]),
                        width=cfg["width"], batch=cfg["batch"])
    _, counters = smoke._port()
    out = smoke.phase_sequential(CPU, counters["dd_expand"],
                                 expect=dict(optimum=opt, **st), **cfg)
    assert out["supersteps"] == st["supersteps"] and out["launches"] == 0


def test_resilience_phase_matches_the_pins_script_at_a_cpu_size():
    """Phase 8 at ``PHASE8_SMALL``, held to what
    ``scripts/resilience_pins.py`` computes from the JAX package at that
    size (the card's run is held to the same script's full-size run,
    pinned in ``PHASE8_EXPECT``)."""
    smoke = _chip_smoke()
    spec = importlib.util.spec_from_file_location(
        "resilience_pins", ROOT / "scripts" / "resilience_pins.py")
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    cfg = smoke.PHASE8_SMALL
    expect = {"flat": pins.pins(cfg, cfg["flat_plan"]),
              "hier": pins.pins(cfg, cfg["hier_plan"], cfg["pod_size"])}
    _, counters = smoke._port()
    out = smoke.phase_resilience(CPU, counters, cfg, expect=expect, turns=1)
    assert out["flat"]["rounds"] == expect["flat"]["rounds"]
    assert out["hier"]["dead"] == 5 and out["flat"]["dead"] == 1
    assert set(out["ms_per_round"]) == {"unarmed", "flat", "hier"}
    assert out["snapshots"]["crash_at"] == 6
    assert out["snapshots"]["restarts"] == 1
    assert out["elastic"]["shrunk_to"] == 7 and out["elastic"]["live"] == 7
    # the card's pins come from the same script at PHASE8's size
    assert set(smoke.PHASE8_EXPECT) == {"flat", "hier"}
    assert set(smoke.PHASE8_EXPECT["flat"]) == set(expect["flat"])


def test_obs_phase_holds_every_check_at_a_cpu_size():
    """Phase 14 at ``PHASE8_SMALL``: the probed replays against the
    unprobed ones (the card holds them to ``PHASE8_EXPECT``), the phase
    summaries, the Prometheus totals, the trace, ``run_resilient``'s
    textfile, and the serving metrics' served total."""
    smoke = _chip_smoke()
    _, counters = smoke._port()
    cfg = smoke.PHASE8_SMALL
    snap = {"repro_serve_served_total": {"values": 10}}
    out = smoke.phase_obs(CPU, counters, cfg, served=(10, snap), turns=2)
    for name in ("flat", "hier"):
        assert sum(out[name]["phase_fractions"].values()) == \
            pytest.approx(1.0, abs=1e-9)
        assert len(out["ms_per_round"][name]["probed"]) == 2
        assert out[name]["overhead_ratio"] > 0
    assert out["trace_counts"]["phase"] == 4 * out["flat"]["rounds"]
    assert out["textfile"]["rounds"] == out["flat"]["rounds"]
    assert out["serve_served_total"] == 10
    with pytest.raises(AssertionError, match="served"):
        smoke.phase_obs(CPU, counters, cfg, served=(11, snap), turns=1)


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


def _assert_first_wave_is_the_plain_computation(out):
    """On the CPU every wrapper takes its plain version: nothing launches,
    and the two first-wave prefills are the same computation."""
    assert set(out["launches"].values()) == {0}
    assert out["first_wave_f32_max_abs_err"] == 0.0
    assert out["first_wave_bf16_max_abs_err"] == 0.0
    dev = out["first_wave_bf16_mean_dev_from_f32"]
    assert dev["kernel"] == dev["plain"] > 0
    assert out["first_wave_greedy_agreement"] == 1.0


def _serve(arch):
    from repro_torch import configs
    out = _chip_smoke().phase_serve(
        CPU, cfg=configs.reduced(configs.get(arch)), n_requests=10,
        prompt_lens=(8, 24), max_new=4, max_seq=30, wave_size=4,
        slow_speed=0.25)
    assert out["requests"] == 10 and out["tokens"] == 40
    assert out["stolen"] > 0 and sum(out["completed"]) == 10
    assert out["decode_steps"] == 4 * out["prefill_waves"]
    _assert_first_wave_is_the_plain_computation(out)
    return out


def test_serve_phase_serves_everything_and_compares_the_first_wave():
    assert set(_serve("llama3.2-1b")["launches"]) == {"flash_attention"}


def test_ssm_serve_phase_counts_the_ssd_scan():
    assert set(_serve("mamba2-2.7b")["launches"]) == {"ssd_scan"}


def test_wave_phase_runs_the_hybrid_through_both_kernels():
    from repro_torch import configs

    smoke = _chip_smoke()
    cfg = configs.reduced(configs.get("zamba2-7b"))
    assert smoke.serve_launches(cfg) == {"flash_attention": 2,
                                         "ssd_scan": 7}
    assert smoke.serve_launches(configs.get("zamba2-7b")) == {
        "flash_attention": 13, "ssd_scan": 81}
    out = smoke.phase_wave(CPU, cfg=cfg, n_prompts=4, prompt_lens=(8, 24),
                           max_new=3, max_seq=30)
    assert out["requests"] == 4 and out["tokens"] == 12
    assert len(out["prefill_ms"]) == 1 and out["decode_steps"] == 3
    assert set(out["launches"]) == {"flash_attention", "ssd_scan"}
    _assert_first_wave_is_the_plain_computation(out)


def test_train_phase_holds_every_gate_at_a_cpu_size():
    """Phase 11 at ``PHASE11_SMALL`` (reduced widths): training falls,
    every gradient is finite and reaches the kernels' inputs in every
    layer, the MoE serving's bulk steal reroutes what the drop baseline
    would drop and drops nothing, its plan equals the CPU's, and the VLM
    prefix prefills behind its patches.  On the CPU the wrappers run the
    plain versions, so the float32 comparisons are exact.  On one intra-op
    thread: the tier-1 run puts several test processes on the host's
    cores, where a thread pool per process mostly waits."""
    smoke = _chip_smoke()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.phase_train(CPU, smoke.PHASE11_SMALL)
    finally:
        torch.set_num_threads(n)
    dense, moe, ssm, vlm = (out[k] for k in ("dense", "moe", "ssm", "vlm"))
    assert dense["launches_expected_per_step"] == {"flash_attention": 8}
    assert len(dense["losses"]) == 4
    assert dense["losses"][-1] < dense["losses"][0]
    for part in (dense, ssm):
        assert part["float32_vs_plain"]["max_grad_err_over_leaf_max"] == 0.0
        assert part["grads_step1"]["finite"]
    assert ssm["launches_expected_per_step"] == {"ssd_scan": 16}
    routing = moe["serve"]["routing"]
    assert routing["rerouted"] > 0 and routing["dropped"] == 0
    assert routing["rerouted"] == routing["dropped_without_steal"]
    assert routing["plan_vs_cpu"]["bit_equal"]
    assert moe["serve"]["first_wave_plan_flips"] == 0
    assert moe["serve"]["requests"] == 10 and moe["serve"]["stolen"] > 0
    assert moe["train"]["grads_step1"]["zero_layer_slices"] == {}
    assert vlm["f32_max_abs_err"] == 0.0
    assert vlm["shape"] == [4, 8, 12]
    # the card's launch expectations at full width
    from repro_torch import configs
    assert smoke.train_launches(configs.get("llama3.2-1b")) == {
        "flash_attention": 32}
    assert smoke.train_launches(smoke._arch_cfg(
        "mamba2-2.7b", n_layers=8)) == {"ssd_scan": 16}


def test_encdec_phase_holds_every_gate_at_a_cpu_size():
    """Phase 12 at ``PHASE12_SMALL`` (reduced seamless-m4t-medium): the
    prefill calls attention once per encoder layer and twice per decoder
    layer (and launches nothing: the split by mode of K6's launches is
    read from its counters), decodes, and its float32 comparisons are exact on the CPU
    (both sides the plain version); training falls, with every layer's
    attention projections reached.  On one intra-op thread."""
    smoke = _chip_smoke()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke.phase_encdec(CPU, smoke.PHASE12_SMALL)
    finally:
        torch.set_num_threads(n)
    serve, train = out["serve"], out["train"]
    assert serve["calls_by_mode"] == {"encoder": 2, "self": 2, "cross": 2}
    # K6's counters move only where it launches, which the CPU never does
    assert serve["launches_by_mode"] == {"encoder": 0, "self": 0,
                                         "cross": 0}
    assert serve["f32_max_abs_err"] == serve["f32_decode_max_abs_err"] == 0
    assert train["launches_expected_per_step"] == {"flash_attention": 12}
    assert train["losses"][-1] < train["losses"][0]
    assert train["grads_step1"]["zero_layer_slices"] == {}
    assert train["float32_vs_plain"]["max_grad_err_over_leaf_max"] == 0.0
    # the card's expectations at full depth: 36 a prefill, 72 a step
    from repro_torch import configs
    cfg = configs.get("seamless-m4t-medium")
    assert smoke.serve_launches(cfg) == {"flash_attention": 36}
    assert smoke.train_launches(cfg) == {"flash_attention": 72}


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
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the references beside 8 one-thread ranks
    try:
        out = smoke.phase_sharded_step(CPU, smoke.PHASE15_SMALL)
    finally:
        torch.set_num_threads(threads)
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
