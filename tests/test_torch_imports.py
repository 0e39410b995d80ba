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
        "          'repro_torch.core.host_queue', 'repro_torch.configs'):\n"
        "    assert m in mods or m in sys.modules, m\n")
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


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
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.runtime.executor import StealRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = torch.zeros((), dtype=torch.int32)
    for call in (lambda: parallel_solve(paper_example()),
                 lambda: StealRuntime(2, 8, spec),
                 lambda: make_queue(8, spec),
                 lambda: make_sharded_queues(2, 8, spec),
                 lambda: make_queue(8, spec, device="cuda"),
                 lambda: serve_main([])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(NotImplementedError, match="mesh"):
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
