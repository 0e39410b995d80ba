"""A configuration's kind (``bench/kinds/<kind>.py``) is all that ties
``bench/run.py`` to a program: a kind written as files alone runs through
``run_cell``; the knapsack kind gives the records the parent of the move
gave; ``run.py`` names no kind."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from _bench_tiny import BIG_SEED, ROOT, tiny_cell, torch_threads  # noqa: F401
from bench.cell import load_cell
from bench.run import run_cell

TOY_KIND = '''
"""Kind ``toy``: the sum of a list of integers, on the device."""

import random


def program(config, device):
    import torch

    return lambda xs: int(torch.tensor(xs, device=device).sum())


def items(traffic, config, seed):
    rng = random.Random(seed)
    while True:
        yield [rng.randrange(traffic["high"]) for _ in range(config["n"])]


def warm_item(traffic, config, seed):
    return [1] * config["n"]


def argument(item):
    return list(item)


def record(config, item, out, ms, error):
    return {"item": item, "ms": ms, "sum": out, "error": error,
            "ok": error is None}


def check(calls):
    for c in calls:
        c["right"] = c["sum"] == sum(c.pop("item"))
    return {"wrong_sum": {"value": sum(not c["right"] for c in calls),
                          "limit": 0}}


class Hooks:
    SPANS = ()
    KERNELS = {}

    def __init__(self, torch):
        self.calls = 0

    def install(self):
        pass

    def remove(self):
        pass

    def harvest(self):
        self.calls += 1

    def record(self):
        return {"counts": {"calls": self.calls}}
'''

TOY_READER = '''
def read(record):
    done = sum(1 for c in record["solves"] if c["ok"])
    return done / record["window_s"]
'''


def _toy_tree(root):
    """A manifest tree holding one cell of the kind ``toy``."""
    files = {
        "BENCHMARK.json": {
            "command": ["python3", "bench/run.py"], "paths": ["bench"],
            "run_seconds": 10,
            "configs": [{"name": "toy-config", "source": "a test",
                         "file": "bench/configs/toy-config.json",
                         "reduced": [], "why": "a kind added as files"}],
            "workloads": [{"name": "toy-sums", "config": "toy-config",
                           "traffic": "toy-lists", "chips": 1,
                           "why": "a test"}],
            "end_to_end": [{"name": "sums_per_s", "unit": "sums/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock"}],
            "per_layer": []},
        "bench/configs/toy-config.json": {"name": "toy-config",
                                          "kind": "toy", "n": 64},
        "bench/workloads/toy-sums.json": {
            "name": "toy-sums", "config": "toy-config",
            "traffic": {"name": "toy-lists", "high": 1000}},
    }
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(json.dumps(data))
    (root / "bench" / "kinds").mkdir()
    (root / "bench" / "kinds" / "toy.py").write_text(TOY_KIND)
    (root / "bench" / "metrics").mkdir()
    (root / "bench" / "metrics" / "sums_per_s.py").write_text(TOY_READER)


def _harness_digest() -> str:
    h = hashlib.sha256()
    for p in sorted((ROOT / "bench").glob("*.py")):
        h.update(p.read_bytes())
    return h.hexdigest()


def test_a_kind_added_as_files_runs(tmp_path, torch_threads):  # noqa: F811
    before = _harness_digest()
    _toy_tree(tmp_path)
    cell = load_cell("toy-sums", tmp_path)
    line = run_cell(cell, BIG_SEED, 60.0, 0, device="cpu", max_solves=5)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 5
    assert line["failed"] == 0 and set(line["metrics"]) == {"sums_per_s"}
    assert line["checks"] == {"wrong_sum": {"value": 0, "limit": 0}}
    # traced: the kind's hooks, the trace's reduction, the same check
    traced = run_cell(cell, BIG_SEED, 60.0, 1, device="cpu", max_solves=3)
    assert traced["correct"] is True and list(traced)[-1] == "checks"
    # the window's own hooks, harvested after each call
    assert traced["counts"]["calls"] == 3
    assert traced["breakdown"]["device_ops"] == []
    # a program that answers wrong is not correct
    wrong = run_cell(cell, BIG_SEED, 60.0, 0, device="cpu", max_solves=4,
                     program=lambda xs: sum(xs) + 1)
    assert wrong["correct"] is False and wrong["failed"] == 4
    assert _harness_digest() == before


# Each solve's (h, optimum, supersteps, transferred) in a CPU rehearsal of
# the cells at n 14, seed BIG_SEED, 8 solves, as the harness gave them
# before the knapsack's parts moved into bench/kinds/dd_knapsack.py.
PARENT = {
    "ks-uncorr-series": [
        [47, 4612, 6, 35], [20, 3743, 3, 9], [72, 6079, 3, 12],
        [80, 6046, 1, 0], [51, 4765, 3, 12], [100, 5984, 1, 0],
        [63, 6216, 3, 12], [43, 5547, 3, 12]],
    "ks-strong-series": [
        [47, 3677, 21, 139], [20, 2041, 5, 30], [72, 8009, 14, 106],
        [80, 7129, 8, 74], [51, 4090, 19, 131], [100, 7469, 1, 0],
        [63, 5971, 18, 135], [43, 3307, 19, 129]],
}
SOLVE_KEYS = ["h", "ms", "optimum", "error", "supersteps", "transferred",
              "ok", "right"]


@pytest.mark.parametrize("name", sorted(PARENT))
def test_the_knapsack_records_are_the_parents(name,
                                              torch_threads):  # noqa: F811
    record = {}
    line = run_cell(tiny_cell(name, n=14), BIG_SEED, 600.0, 0,
                    device="cpu", max_solves=8, record_out=record)
    assert line["correct"] is True
    assert list(record) == ["setup_s", "window_s", "solves"]
    assert all(list(s) == SOLVE_KEYS for s in record["solves"])
    assert [[s["h"], s["optimum"], s["supersteps"], s["transferred"]]
            for s in record["solves"]] == PARENT[name]


def test_the_traced_knapsack_record_is_the_parents(
        torch_threads):  # noqa: F811
    record = {}
    line = run_cell(tiny_cell("ks-strong-series", n=14), BIG_SEED, 600.0,
                    1, device="cpu", max_solves=4, record_out=record)
    assert list(record) == ["setup_s", "window_s", "solves", "rounds",
                            "counts", "trace", "peak"]
    assert [[s["h"], s["optimum"], s["supersteps"], s["transferred"]]
            for s in record["solves"]] == PARENT["ks-strong-series"][:4]
    assert list(record["counts"]) == [
        "explore_calls", "explore_layers", "explore_ops", "explore_bytes",
        "profile_stop_s", "trace_reduce_s"]
    assert record["counts"]["explore_calls"] == 64
    assert record["counts"]["explore_ops"] == 3214848
    assert len(record["rounds"]) == 48
    assert list(record["rounds"][0]) == ["worker_body", "exchange"]
    assert list(record["trace"]) == [
        "window_trace_s", "instrument_host_s", "busy_s", "device_ops",
        "unattributed_ops", "explore_device_s", "explore_ops_by_name",
        "top_device_ops", "idle_by_host"]
    assert list(line["counts"])[-4:] == [
        "rounds", "unattributed_ops", "instrument_host_s",
        "explore_ops_by_name"]


def test_run_names_no_kind():
    source = (ROOT / "bench" / "run.py").read_text().lower()
    for word in ("knapsack", "pisinger", "parallel", "optimum", "explore",
                 "superstep", "generator", "instance", r"\bdd[-_]",
                 r"repro_torch\.core"):
        assert not re.search(word, source), word


def test_an_unknown_kind_is_refused(tmp_path):
    _toy_tree(tmp_path)
    path = tmp_path / "bench" / "configs" / "toy-config.json"
    path.write_text(json.dumps({"name": "toy-config", "kind": "no-such",
                                "n": 4}))
    with pytest.raises(KeyError, match="no-such"):
        load_cell("toy-sums", tmp_path)
