"""``BENCHMARK.json`` against the benchmark's contract, the files it
names, and the rule that nothing a run loads is JAX or the JAX
package."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest

from _bench_tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if "/" in word and (ROOT / word).exists():
            assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_units_and_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["workloads"]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_every_part_is_a_file_found_by_name():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        wl = json.loads((ROOT / "bench" / "workloads"
                         / f"{w['name']}.json").read_text())
        assert wl["config"] == w["config"]
        assert wl["traffic"]["name"] == w["traffic"]
    assert used == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()


def test_every_configuration_names_a_kind_with_a_module():
    from bench.cell import load_kind

    for c in MANIFEST["configs"]:
        kind = json.loads((ROOT / c["file"]).read_text())["kind"]
        assert NAME.match(kind)
        module = load_kind(kind, ROOT)
        for name in ("program", "items", "warm_item", "argument", "record",
                     "check", "Hooks"):
            assert hasattr(module, name), (kind, name)


def test_each_metric_moves_what_its_cells_report():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in MANIFEST["end_to_end"]}
    for cell in cells:
        reports = {n for n, ws in e2e.items() if cell in ws}
        assert "setup_s" in reports and len(reports) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]]


def test_run_seconds_fits_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_test_files_are_not_named_as_the_repos_tests():
    ours = {p.name for p in (ROOT / "bench" / "tests").glob("*.py")}
    theirs = {p.name for p in (ROOT / "tests").glob("*.py")}
    assert not ours & theirs


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A subprocess imports the harness and the reference and rehearses a
    run on the CPU, then lists the forbidden top-level modules it holds."""
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import bench.run, bench.tracing, bench.cell\n"
        "import bench.reference.optimum, bench.reference.pisinger\n"
        "sys.path.insert(0, sys.argv[1] + '/bench/tests')\n"
        "from _bench_tiny import tiny_cell\n"
        "line = bench.run.run_cell(tiny_cell('ks-uncorr-series', n=6), 1,"
        " 0.2, 1, device='cpu')\n"
        "assert line['correct'], line\n"
        "print(bench.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_forbidden_check_compares_whole_top_level_names():
    from bench.run import forbidden_modules

    assert forbidden_modules(["repro_torch", "repro_torch.core.dd",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["repro.core", "jaxlib._jax", "jax",
                              "flax.linen", "torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_refuses_without_a_card():
    """No card: no result, a non-zero exit (decided in the test: on a
    machine with a card this has nothing to show)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "ks-uncorr-series", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
