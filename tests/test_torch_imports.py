"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, the port's entry points default to CUDA
and raise without it, and ``chip_smoke.py`` fails (no result line) where
there is no GPU or no checkout around it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _run(args, cwd=ROOT, **env):
    full_env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full_env,
                          capture_output=True, text=True, timeout=300)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke._port()\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 40 and not bad, bad\n"
        "for m in ('repro_torch.models.transformer',\n"
        "          'repro_torch.kernels.flash_attention.ops',\n"
        "          'repro_torch.serve.engine', 'repro_torch.launch.serve',\n"
        "          'repro_torch.core.host_queue', 'repro_torch.configs',\n"
        "          'repro_torch.core.relaxed', 'repro_torch.core.queue',\n"
        "          'repro_torch.analysis.sanitize',\n"
        "          'repro_torch.analysis.linearize',\n"
        "          'repro_torch.analysis.lint', 'repro_torch.data.pipeline',\n"
        "          'repro_torch.data.synthetic', 'repro_torch.core.lanes',\n"
        "          'repro_torch.launch.mesh',\n"
        "          'repro_torch.distributed.executor',\n"
        "          'repro_torch.distributed.launch',\n"
        "          'repro_torch.distributed.serve',\n"
        "          'repro_torch.serve.paged_kv', 'repro_torch.serve.decode',\n"
        "          'repro_torch.models.moe', 'repro_torch.train.optimizer',\n"
        "          'repro_torch.train.trainer', 'repro_torch.launch.train',\n"
        "          'repro_torch.kernels._backward',\n"
        "          'repro_torch.models.encdec', 'repro_torch.models.zoo',\n"
        "          'repro_torch.obs', 'repro_torch.obs.metrics',\n"
        "          'repro_torch.obs.phase', 'repro_torch.obs.trace',\n"
        "          'repro_torch.launch.dryrun', 'repro_torch.launch.roofline',\n"
        "          'repro_torch.launch.perf', 'repro_torch.launch.report',\n"
        "          'repro_torch.kernels.bounds'):\n"
        "    assert m in mods or m in sys.modules, m\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_jax_module_has_a_counterpart_in_the_port():
    """The two packages' file lists: every module of ``src/repro`` has a
    file of the same path under ``src/repro_torch`` (Pallas kernel
    modules have their CUDA sources and wrappers there instead)."""
    jax_pkg = ROOT / "src" / "repro"
    missing = sorted(
        str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
        if not (PORT / p.relative_to(jax_pkg)).exists()
        and not (p.parent.parent.name == "kernels"
                 and p.name == "kernel.py"))
    assert not missing, missing


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro_in_an_import(path):
    """Also the imports inside functions, which an import test can miss."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.core.dd.knapsack import paper_example
    from repro_torch.core.dd.parallel import parallel_solve
    from repro_torch.core.ops import make_queue
    from repro_torch.core.sharded_queue import make_sharded_queues
    from repro_torch import configs
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.attention import AttnConfig
    from repro_torch.models.attention import make_cache as attn_make_cache
    from repro_torch.models.zoo import build_model
    from repro_torch.runtime.executor import StealRuntime
    from repro_torch.analysis.linearize import check_backend
    from repro_torch.core.queue import PagedQueue

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = torch.zeros((), dtype=torch.int32)
    for call in (lambda: parallel_solve(paper_example()),
                 lambda: StealRuntime(2, 8, spec),
                 lambda: make_queue(8, spec),
                 lambda: make_sharded_queues(2, 8, spec),
                 lambda: make_queue(8, spec, device="cuda"),
                 lambda: PagedQueue(8, spec),
                 lambda: check_backend("reference", capacity=4, max_steal=2),
                 lambda: serve_main([]),
                 lambda: attn_make_cache(1, 2, 8, AttnConfig(2, 1, 4),
                                         torch.float32),
                 *(lambda arch=arch: build_model(configs.reduced(
                     configs.get(arch))).make_cache(2, 8)
                   for arch in ("llama3.2-1b", "mamba2-2.7b", "zamba2-7b"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # one lane per rank needs a process group to be its lanes
    with pytest.raises(RuntimeError, match="process group"):
        parallel_solve(paper_example(), execution="mesh", device="cpu")
    assert make_queue(8, spec, device="cpu").lo.device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu_and_without_the_repo(tmp_path):
    res = _run(["chip_smoke.py"], CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_resilience_modules_import_alone_and_default_to_cuda(monkeypatch):
    """The resilience slice's modules load without JAX, and its entry
    points (the runtime armed or in pods, the padded runtime, the
    sequential solver, the resilient launcher) refuse to run on the CPU
    unless asked."""
    code = (
        "import importlib, sys\n"
        "for m in ('repro_torch.runtime.resilience',\n"
        "          'repro_torch.train.checkpoint', 'repro_torch.train.fault',\n"
        "          'repro_torch.distributed', 'repro_torch.distributed.elastic',\n"
        "          'repro_torch.launch.resilient', 'repro_torch.core.dd.bnb'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr

    from repro_torch.core.dd.bnb import solve
    from repro_torch.core.dd.knapsack import paper_example
    from repro_torch.distributed.elastic import padded_runtime
    from repro_torch.launch.resilient import main as resilient_main
    from repro_torch.runtime import FaultPlan, StealRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = torch.zeros((), dtype=torch.int32)
    for call in (lambda: solve(paper_example()),
                 lambda: StealRuntime(4, 8, spec, pod_size=2,
                                      fault_plan=FaultPlan()),
                 lambda: padded_runtime(2, 8, spec, w_max=4),
                 lambda: resilient_main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mesh_modules_import_alone_and_default_to_cuda(monkeypatch,
                                                       tmp_path):
    """The one-lane-per-process slice's modules load without JAX; a mesh
    needs a process group, and its lanes default to CUDA and raise
    without it, as the stacked lanes of ``launch_runtime`` do."""
    code = (
        "import importlib, sys\n"
        "for m in ('repro_torch.core.lanes', 'repro_torch.launch.mesh',\n"
        "          'repro_torch.distributed.executor',\n"
        "          'repro_torch.distributed.launch'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr

    import torch.distributed as dist

    from repro_torch.distributed import launch_runtime
    from repro_torch.launch.mesh import make_worker_mesh

    spec = torch.zeros((), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="process group"):
        make_worker_mesh(1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_runtime(2, 8, spec, execution="vmap")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        for call in (lambda: make_worker_mesh(1),
                     lambda: launch_runtime(1, 8, spec, execution="mesh")):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        rt = launch_runtime(1, 8, spec, execution="mesh", device="cpu")
        assert rt.device.type == "cpu" and rt.lanes.n_local == 1
    finally:
        dist.destroy_process_group()


def test_decode_modules_import_alone_and_default_to_cuda(monkeypatch):
    """The decode slice's modules load without JAX, and its entry points
    (the paged pool, the decode carry, the decode cluster in each mode,
    the device admission master, the decode launcher) refuse to run on the
    CPU unless asked."""
    code = (
        "import importlib, sys\n"
        "for m in ('repro_torch.serve.paged_kv', 'repro_torch.serve.decode',\n"
        "          'repro_torch.distributed.serve'):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr

    from repro_torch import configs
    from repro_torch.distributed import RuntimeAdmissionMaster
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models.zoo import build_model
    from repro_torch.serve.decode import (DecodeCluster, DecodePolicy,
                                          encode_requests, init_decode_state)
    from repro_torch.serve.paged_kv import make_pool
    from repro_torch.serve.scheduler import Request

    model = build_model(configs.reduced(configs.get("llama3.2-1b")))
    params = model.init(torch.Generator().manual_seed(0))
    pol = DecodePolicy(n_slots=2, max_prompt=4, max_new=4, page_size=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_pool(model, n_slots=2, n_pages=4, page_size=4,
                                   pages_per_seq=2),
                 lambda: init_decode_state(model, pol, 2),
                 lambda: encode_requests([Request(prompt=[1], max_new=2)], pol, 0),
                 lambda: RuntimeAdmissionMaster(2),
                 *(lambda ex=ex: DecodeCluster(model, params, policy=pol,
                                               n_lanes=2, execution=ex)
                   for ex in ("host", "vmap")),
                 lambda: serve_main(["--decode"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert init_decode_state(model, pol, 2, device="cpu")[
        "table"].device.type == "cpu"
