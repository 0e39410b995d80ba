"""The port's four examples (``examples/torch_*.py``) on the CPU: each
refuses to run without a GPU unless ``--device cpu`` is given, the
quickstart prints what the JAX package's quickstart prints, and the
knapsack solver's optimum is the JAX package's DP optimum.  Phase 16 of
``chip_smoke.py`` (rehearsed in ``tests/test_torch_smoke.py``) runs all
four and holds them to their own results."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.dd.knapsack import dp_solve, random_instance

from _torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
EXAMPLES = ("quickstart", "knapsack_solver", "serve_demo", "train_lm")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, *args, **env):
    full = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "OMP_NUM_THREADS": "1", **env}
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], cwd=ROOT, env=full, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_a_gpu_unless_asked_for_the_cpu(name):
    res = _run(f"torch_{name}.py", CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr, res.stderr[-2000:]


def test_quickstart_prints_what_the_jax_quickstart_prints():
    """Every line the two quickstarts share, equal: the host queue's pop
    and steal, the device queue's pop and bulk steal, and the sizes
    before and after one master superstep."""
    got = _run("torch_quickstart.py", "--device", "cpu")
    want = _run("quickstart.py", JAX_PLATFORMS="cpu")
    assert got.returncode == 0 and want.returncode == 0, got.stderr
    shared = ("owner pops newest:", "stealer got", "device pop:",
              "device bulk steal:", "sizes before:")

    def lines(out):
        return [line for line in out.splitlines() if line.startswith(shared)]
    assert len(lines(got.stdout)) == len(shared)
    assert lines(got.stdout) == lines(want.stdout)


def test_knapsack_solver_finds_the_jax_package_dp_optimum():
    """At ``--n 10``: the DP oracle it prints, its sequential and parallel
    optima equal the JAX package's ``dp_solve`` on the same instance, and
    the paper example's optimum is Eq. 1's 15."""
    smoke = _chip_smoke()
    run = smoke.run_example("knapsack_solver", ["--n", "10"], CPU, 120)
    ints = run["ints"]
    want = dp_solve(random_instance(10, seed=3))
    assert ints["oracle"] == ints["sequential"] == ints["parallel"] == want
    assert ints["paper_optimum"] == 15 and ints["supersteps"] > 0
