"""The port's dry run, roofline, perf variants and report against the JAX
package on the CPU (no spawn).

* ``model_flops_for`` and ``input_specs`` equal the JAX package's for
  every arch and shape cell.
* The per-device argument bytes of the parameters, optimizer state,
  cache and batch the port's trace takes on both production meshes equal
  what ``jax.eval_shape`` of the JAX model and its spec trees give,
  block by block (``ceil(n / k)`` for a dimension that does not split).
* ``roofline.collective_bytes`` on a recorded collective log equals the
  JAX package's ``collective_bytes`` on HLO lines rendered from the same
  records (and on ``tests/test_roofline.py``'s snippets as records).
* A reduced llama cell traced on a ``(2, 4)`` recording mesh has the JAX
  package's result schema, and both packages' reports render it (and the
  JAX package's own rows) row for row; ``obs_section`` too.
* ``perf.VARIANTS`` is the JAX package's.
* K6 / K7's counts: ``visible_pairs`` is ``visible().sum()``, and on
  ``meta`` the wrappers return their shapes and charge those counts.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported (and ``repro.launch.perf`` by ``setdefault``): both are imported
only after ``jax.devices()`` has started this process's backend, and the
variable is restored, so later JAX tests in the worker keep their
devices.
"""

import dataclasses
import functools
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.models import build_model as jax_build_model
from repro.models.zoo import input_specs as jax_input_specs
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.kernels import bounds
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.flash_attention.ref import visible
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import dryrun, perf, report, roofline
from repro_torch.launch.mesh import make_recording_mesh
from repro_torch.models.zoo import input_specs

from _torch_parity import one_torch_thread  # noqa: F401

CELLS = [(a, s.name) for a in configs.ARCH_IDS
         for s in configs.cells_for(configs.get(a))]
MESH_SIZES = {False: {"data": 16, "model": 16},
              True: {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _jax_launch():
    """``repro.launch.dryrun`` and ``repro.launch.perf``, imported after
    the backend started, ``XLA_FLAGS`` as it was before."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
        import repro.launch.perf as jperf
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry, jperf


def _shape(name):
    return next(s for s in configs.SHAPES if s.name == name)


def test_importing_the_jax_dry_run_leaves_xla_flags_as_they_were():
    before = os.environ.get("XLA_FLAGS")
    _jax_launch()
    assert os.environ.get("XLA_FLAGS") == before


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_model_flops_equal_the_jax_package(arch):
    jdry, _ = _jax_launch()
    for s in configs.cells_for(configs.get(arch)):
        js = next(x for x in jconfigs.SHAPES if x.name == s.name)
        assert dryrun.model_flops_for(configs.get(arch), s) == \
            jdry.model_flops_for(jconfigs.get(arch), js)


def _jax_dtype(d) -> str:
    return str(np.dtype(d))


@pytest.mark.parametrize("pods", [False, True])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_equal_the_jax_package(arch, pods):
    kw = {"pod_axis": "pod"} if pods else {}
    for s in configs.SHAPES:
        js = next(x for x in jconfigs.SHAPES if x.name == s.name)
        want_sds, want_ps = jax_input_specs(jconfigs.get(arch), js,
                                            JaxParallelConfig(**kw))
        got_sds, got_ps = input_specs(configs.get(arch), s,
                                      ParallelConfig(**kw))
        assert list(got_sds) == list(want_sds)
        for k, w in want_sds.items():
            assert tuple(got_sds[k].shape) == w.shape, (s.name, k)
            assert str(got_sds[k].dtype).replace("torch.", "") == \
                _jax_dtype(w.dtype)
            assert tuple(got_ps[k]) == tuple(want_ps[k]), (s.name, k)


def _block_bytes(sds_tree, spec_tree, sizes) -> int:
    """Bytes of one device's blocks: each dimension split ``ceil`` over
    the product of its spec entry's axes that the mesh has."""
    total = 0

    def one(spec, sds):
        nonlocal total
        dims = list(sds.shape)
        for d, entry in enumerate(spec):
            names = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = math.prod(sizes.get(a, 1) for a in names)
            dims[d] = -(-dims[d] // k)
        total += math.prod(dims) * np.dtype(sds.dtype).itemsize

    jax.tree_util.tree_map(
        one, spec_tree, sds_tree,
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return total


@functools.lru_cache(maxsize=None)
def _jax_params(arch, pods):
    jm = jax_build_model(jconfigs.get(arch), JaxParallelConfig(
        pod_axis="pod" if pods else None))
    return jm, jax.eval_shape(jm.init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("pods", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_equal_what_the_jax_spec_trees_give(arch, shape,
                                                           pods):
    sizes = MESH_SIZES[pods]
    jm, sds = _jax_params(arch, pods)
    s = _shape(shape)
    js = next(x for x in jconfigs.SHAPES if x.name == shape)
    specs = jm.param_specs()
    want = {"params": _block_bytes(sds, specs, sizes)}
    bsds, bps = jax_input_specs(jconfigs.get(arch), js, JaxParallelConfig(
        pod_axis="pod" if pods else None))
    want["batch"] = _block_bytes(bsds, bps, sizes)
    B, S = js.global_batch, js.seq_len
    if js.kind == "train":
        mw = jm.cfg.param_dtype == "bfloat16"
        osds = jax.eval_shape(
            lambda p: jopt.adamw_init(p, master_weights=mw), sds)
        want["opt"] = _block_bytes(
            osds, jopt.opt_state_specs(specs, master_weights=mw), sizes)
    elif js.kind == "decode":
        args = (B, S, S) if jm.cfg.family == "encdec" else (B, S)
        csds = jax.eval_shape(lambda: jm.make_cache(*args))
        csds = {k: v for k, v in csds.items() if k != "pos"}
        cspecs = {k: v for k, v in jm.cache_specs(S, B).items()
                  if k != "pos"}
        want["cache"] = _block_bytes(csds, cspecs, sizes)
        if s.kind == "decode":   # the batch the step takes: the tokens
            want["batch"] = _block_bytes(bsds, bps, sizes)
    got = dryrun.argument_bytes(configs.get(arch), s, pods)
    assert got == want


def _hlo_dtype(dtype: str) -> str:
    return {"float32": "f32", "bfloat16": "bf16", "float16": "f16",
            "int32": "s32", "int64": "s64", "float64": "f64",
            "uint8": "u8", "bool": "pred"}[dtype]


def _render(records) -> str:
    """HLO lines of a collective log, as XLA prints them."""
    lines = []
    for i, (kind, operand, result, dtype, g, _axis) in enumerate(records):
        t = _hlo_dtype(dtype)
        res = f"{t}[{','.join(map(str, result))}]"
        opd = f"{t}[{','.join(map(str, operand))}]"
        groups = "{{" + ",".join(map(str, range(g))) + "}}"
        lines.append(f"  %c{i} = {res}{{0}} {kind}({opd}{{0}} %x{i}), "
                     f"replica_groups={groups}")
    return "\n".join(lines)


def _reduced_llama(layers=2):
    return dataclasses.replace(configs.reduced(configs.get("llama3.2-1b")),
                               n_layers=layers)


SNIPPET_RECORDS = [  # tests/test_roofline.py's snippets
    ("all-gather", (4, 128), (64, 128), "float32", 16, None),
    ("all-reduce", (1024,), (1024,), "float32", 4, None),
    ("collective-permute", (8, 8), (8, 8), "bfloat16", 4, None),
    ("reduce-scatter", (64,), (16,), "float32", 4, None),
]


@pytest.mark.parametrize("source", ["snippets", "trace"])
def test_collective_bytes_equal_the_jax_parser_on_rendered_records(source):
    if source == "snippets":
        records, n = SNIPPET_RECORDS, 16
    else:
        mesh = make_recording_mesh((2, 4), ("data", "model"))
        shape = ShapeConfig("t", 32, 8, "train")
        records = dryrun.trace_cell(_reduced_llama(), shape, mesh,
                                    ParallelConfig())["records"]
        n = 8
        assert {r[0] for r in records} == {"all-gather", "all-reduce",
                                            "reduce-scatter"}
    got = roofline.collective_bytes(records, n)
    want = jroof.collective_bytes(_render(records), n)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


# the JAX package's run_cell result (src/repro/launch/dryrun.py), where
# the port's memory analysis names its fit ``fits_hbm`` (the H100's 80 GB)
# in place of ``fits_16g``
JAX_KEYS = {"arch", "shape", "mesh", "status", "compile_s",
            "memory_analysis", "cost_analysis", "collectives",
            "collective_bytes_per_device", "roofline", "bottleneck",
            "model_flops", "useful_ratio"}
JAX_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "peak_bytes", "fits_16g"}


@functools.lru_cache(maxsize=None)
def _reduced_result():
    mesh = make_recording_mesh((2, 4), ("data", "model"))
    return dryrun.cell_result("llama3.2-1b", _reduced_llama(),
                              ShapeConfig("train_4k", 64, 8, "train"), mesh,
                              "16x16", ParallelConfig())


def test_a_reduced_cell_has_the_jax_result_schema():
    r = _reduced_result()
    assert set(r) == JAX_KEYS
    assert set(r["memory_analysis"]) == (JAX_MEMORY_KEYS - {"fits_16g"}) \
        | {"fits_hbm"}
    assert set(r["collectives"]) == set(jroof._COLLECTIVES)
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert r["status"] == "ok" and 0 < r["useful_ratio"] <= 1
    ma = r["memory_analysis"]
    assert ma["alias_bytes"] == ma["output_bytes"] - 12   # + 3 metrics
    assert ma["peak_bytes"] == ma["argument_bytes"] + ma["temp_bytes"]
    assert r["collective_bytes_per_device"] > 0


def _rows(text: str):
    return [ln for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| arch")]


def test_report_rows_equal_the_jax_report():
    """On one results list (the port's row, its fit also under the JAX
    key, a row in the JAX schema and an error) both reports render the
    same rows; the port's report reads the port's fit key alone."""
    ours = json.loads(json.dumps(_reduced_result()))
    assert "| Y |" in report.dryrun_section([ours])
    ours["memory_analysis"]["fits_16g"] = ours["memory_analysis"][
        "fits_hbm"]
    jax_row = json.loads(json.dumps(ours))
    jax_row["memory_analysis"].pop("fits_hbm")
    jax_row.update(arch="granite-3-2b", mesh="2x16x16")
    results = [ours, jax_row,
               {"arch": "zamba2-7b", "shape": "long_500k", "mesh": "16x16",
                "status": "error", "error": "RuntimeError: boom"}]
    for fn in ("dryrun_section", "roofline_section"):
        got = _rows(getattr(report, fn)(results))
        assert got == _rows(getattr(jreport, fn)(results)), fn
        assert got
    assert "H100" in report.dryrun_section(results)
    assert "v5e" not in report.dryrun_section(results) + \
        report.roofline_section(results)


def test_obs_section_renders_the_jax_schema():
    bench = {"obs_overhead": {
        "probe_overhead": 1.0213, "overhead_limit": 1.1, "gates_ok": False,
        "gates": {"bit_identical": True, "launch_identical": False},
        "phase_breakdown": {
            "flat": {"timed_rounds": 46, "phases": {
                "worker_body": {"fraction": 0.21},
                "exchange": {"fraction": 0.30},
                "splice": {"fraction": 0.41},
                "adaptive_update": {"fraction": 0.08}}},
            "hier": {"timed_rounds": 82, "phases": {
                "worker_body": {"fraction": 0.10},
                "splice": {"fraction": 0.68}}}}}}
    got, want = report.obs_section(bench), jreport.obs_section(bench)
    data = [ln for ln in got.splitlines()
            if ln.startswith(("- probe", "| "))]
    assert data == [ln for ln in want.splitlines()
                    if ln.startswith(("- probe", "| "))]
    assert len(data) == 4 and "| hier | 82 | 10% | - | 68% | - |" in data


def test_report_main_renders_a_dry_run_file(tmp_path, capsys):
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps([_reduced_result()]))
    report.main([str(path)])
    out = capsys.readouterr().out
    assert "## §Dry-run" in out and "## §Roofline" in out
    assert "§Observability" not in out


def test_perf_variants_equal_the_jax_package():
    _, jperf = _jax_launch()
    assert perf.VARIANTS == jperf.VARIANTS


@pytest.mark.parametrize("S,T,causal,window", [
    (1, 1, True, None), (7, 7, True, None), (5, 9, True, None),
    (9, 5, True, None), (8, 8, True, 3), (6, 11, True, 4),
    (6, 11, False, None), (12, 4, False, 2)])
def test_visible_pairs_count_the_masks(S, T, causal, window):
    assert bounds.visible_pairs(S, T, causal=causal, window=window) == \
        int(visible(S, T, causal=causal, window=window).sum())


class _Sink:
    def __init__(self):
        self.calls, self.depth = [], 0

    def begin(self, name, ops, nbytes):
        self.calls.append((name, ops, nbytes))
        self.depth += 1

    def end(self):
        self.depth -= 1


def test_kernels_on_meta_return_shapes_and_charge_their_counts():
    sink = _Sink()
    bounds.SINKS.append(sink)
    try:
        q = torch.empty((2, 16, 4, 32), device="meta")
        k = torch.empty((2, 16, 2, 32), device="meta")
        o = flash.mha(q, k, k, causal=True)
        x = torch.empty((2, 16, 3, 8), device="meta")
        dt = torch.empty((2, 16, 3), device="meta")
        A = torch.empty((3,), device="meta")
        Bm = torch.empty((2, 16, 8), device="meta")
        y, fin = ssd_ops.ssd(x, dt, A, Bm, Bm, A, chunk=8)
    finally:
        bounds.SINKS.remove(sink)
    assert o.shape == q.shape and o.device.type == "meta"
    assert y.shape == x.shape and fin.shape == (2, 3, 8, 8)
    assert sink.depth == 0
    assert sink.calls == [
        ("flash_attention", *bounds.flash_counts(
            2, 16, 16, 4, 2, 32, causal=True, window=None, itemsize=4)),
        ("ssd_scan", *bounds.ssd_counts(2, 16, 3, 8, 8, 8, 4))]
    assert flash.mha.launches == 0 and ssd_ops.ssd.launches == 0


def test_the_dry_run_cli_traces_a_full_size_cell(tmp_path):
    out = tmp_path / "d.json"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(out)])
    (r,) = json.loads(out.read_text())
    assert r["status"] == "ok" and r["mesh"] == "16x16"
    assert r["memory_analysis"]["fits_hbm"]
    assert r["cost_analysis"]["flops_per_device"] > 0
