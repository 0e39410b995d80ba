"""``chip_smoke.py``'s phases, rehearsed on the CPU at a small size: the
kernel checks (there the wrappers run the plain versions), the backlog
supersteps across backends and exchanges, the solver phase against the
JAX package's results for the same configuration, and the serving phase on
reduced llama3.2-1b.  On the card the script runs the same code at full
size."""

import importlib.util
from pathlib import Path

import torch

from repro.core.dd.knapsack import random_instance as jax_random_instance
from repro.core.dd.parallel import parallel_solve as jax_parallel_solve
from repro.core.policy import StealPolicy as JaxPolicy

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# K6 timed at a CPU-sized shape (the card times the serving slice's).
FLASH_SMALL = (2, 128, 128, 4, 2, 32, True, None, None, "bfloat16")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kernel_phase_checks_every_kernel():
    smoke = _chip_smoke()
    out = smoke.phase_kernels(CPU, flash_shape=FLASH_SMALL)
    assert set(out) == {name for name, _, _ in smoke.KERNELS}
    for name, row in out.items():
        assert row["max_abs_err"] == 0.0 and row["parity_cases"] >= 9, name
        assert row["bound_ms"] > 0
        assert row["library_ms"] > 0, name
    assert out["flash_attention"]["parity_cases"] == 11
    assert out["flash_attention"]["bound_by"] == "bytes"  # at this tiny size


def test_queue_phase_agrees_across_backends_and_conserves():
    smoke = _chip_smoke()
    out = smoke.phase_queue(CPU, lanes=8, capacity=512, backlog=300,
                            max_steal=256, rounds=8)
    assert out["items"] == 4 * 300
    assert out["moved"] == 4 * 150  # every empty lane took half a victim
    assert set(out["ms_per_superstep"]) == {"cuda/compact", "cuda/dense",
                                            "reference/compact"}


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
                                    "ring_slice", "ring_transfer"}


def test_serve_phase_serves_everything_and_compares_the_first_wave():
    from repro_torch import configs

    smoke = _chip_smoke()
    _, counters = smoke._port()
    out = smoke.phase_serve(CPU, counters["flash_attention"],
                            cfg=configs.reduced(configs.get("llama3.2-1b")),
                            n_requests=10, prompt_lens=(8, 24), max_new=4,
                            max_seq=30, wave_size=4, slow_speed=0.25)
    assert out["requests"] == 10 and out["tokens"] == 40
    assert out["stolen"] > 0 and sum(out["completed"]) == 10
    assert out["decode_steps"] == 4 * out["prefill_waves"]
    # on the CPU K6's wrapper takes its plain version: nothing launches,
    # and the two first-wave prefills are the same computation
    assert out["flash_launches"] == 0
    assert out["first_wave_f32_max_abs_err"] == 0.0
    assert out["first_wave_bf16_max_abs_err"] == 0.0
    dev = out["first_wave_bf16_mean_dev_from_f32"]
    assert dev["k6"] == dev["plain"] > 0
    assert out["first_wave_greedy_agreement"] == 1.0
