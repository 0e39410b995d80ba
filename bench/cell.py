"""Finding a cell's parts by name: its entry in ``BENCHMARK.json``, its
workload file ``bench/workloads/<cell>.json`` (the traffic parameters),
its configuration file, the module of the configuration's kind
``bench/kinds/<kind, '-' as '_'>.py`` (the program, its items, its
check), and the reader ``bench/metrics/<metric>.py`` of each metric it
reports.  Adding a cell, a configuration, a kind or a metric adds files
and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["ROOT", "BENCH", "load_manifest", "load_kind", "Cell",
           "load_cell"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _module(path: Path, name: str):
    """The file at ``path`` loaded as the module ``name`` (registered in
    ``sys.modules`` while it runs, as an import would)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _reader(root: Path, name: str) -> Callable:
    return _module(root / "bench" / "metrics" / f"{name}.py",
                   f"bench_metric_{name.replace('.', '_').replace('-', '_')}"
                   ).read


def load_kind(kind: str, root: Path = ROOT):
    """The module ``bench/kinds/<kind, '-' as '_'>.py`` under ``root``.

    It gives ``bench/run.py`` everything that depends on the program:

    - ``program(config, device)``: the program, a function of one
      argument;
    - ``items(traffic, config, seed)``: the window's endless stream of
      items, and ``warm_item(traffic, config, seed)``, the set-up's;
    - ``argument(item)``: the program's argument for an item, made
      before the call's clock starts;
    - ``record(config, item, out, ms, error)``: one call's record, a dict
      with ``ok`` (the call did its work within the configuration's
      limits); ``out`` is None where the call raised ``error``;
    - ``check(records)``: once the window has closed, sets each record's
      ``right`` from a plain reference and returns the numbers compared,
      ``{name: {"value": ..., "limit": ...}}``;
    - ``Hooks(torch)``: the traced run's wrappers, with ``install``,
      ``harvest`` (after each call), ``remove``, ``record()`` (what the
      traced window adds to the record), ``SPANS`` (its spans, innermost
      first) and ``KERNELS`` (``{key: span}``: the device seconds of the
      operations launched inside each span, ``<key>_device_s``).
    """
    stem = kind.replace("-", "_").replace(".", "_")
    path = root / "bench" / "kinds" / f"{stem}.py"
    if not path.is_file():
        raise KeyError(f"no module {path} for kind {kind!r}")
    return _module(path, f"bench_kind_{stem}")


class Cell:
    """One workload of the manifest with everything it names."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT) -> None:
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(entries)}")
        self.entry = entries[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        self.workload = json.loads(
            (root / "bench" / "workloads" / f"{name}.json").read_text())
        if self.workload["config"] != self.entry["config"]:
            raise ValueError(f"{name}: workload file names configuration "
                             f"{self.workload['config']!r}, BENCHMARK.json "
                             f"{self.entry['config']!r}")
        if self.workload["traffic"]["name"] != self.entry["traffic"]:
            raise ValueError(f"{name}: workload file's traffic is "
                             f"{self.workload['traffic']['name']!r}, "
                             f"BENCHMARK.json's {self.entry['traffic']!r}")
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.kind = load_kind(self.config["kind"], root)
        self.traffic = self.workload["traffic"]
        # an end-to-end metric without a ``workloads`` list is every
        # cell's (``setup_s``); every per-layer metric lists its cells
        e2e = [m for m in manifest["end_to_end"]
               if name in m.get("workloads", [name])]
        layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
        self.metrics: Dict[int, List[dict]] = {0: e2e, 1: layer}
        self._root = root

    def readers(self, trace: int) -> Dict[str, tuple]:
        """``{metric: (unit, read)}`` of what a run with ``--trace
        trace`` reports."""
        return {m["name"]: (m["unit"], _reader(self._root, m["name"]))
                for m in self.metrics[trace]}


def load_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(load_manifest(root), name, root)
