"""The port's static lint (``repro_torch.analysis.lint``): the port's tree
lints clean; planted D1 (use after donate), U1 and K1 (a CUDA kernel
package without its plain version, wrapper or test) findings are caught,
and the K2 mirror (in-place kernels serve BulkOps methods with donate=)
holds; D1 reports what the JAX package's lint reports."""

from pathlib import Path

from repro.analysis import lint as jlint
from repro_torch.analysis import lint

REPO = lint.REPO_ROOT


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_port_tree_lints_clean(capsys):
    findings = lint.lint_paths([REPO / d for d in lint.DEFAULT_PATHS])
    assert findings == [], "\n".join(str(f) for f in findings)
    assert lint.main([]) == 0
    assert "lint: clean" in capsys.readouterr().out


def test_planted_use_after_donate_is_caught_as_in_the_jax_lint(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "def f(ops, q, batch, n):\n"
        "    q2, pushed = ops.push(q, batch, n, donate=True)\n"
        "    return q.size, pushed\n"
        "def g(self, batch, n):\n"
        "    out = self.ops.steal(self.state, 0.5, max_steal=8, donate=True)\n"
        "    return self.state.lo\n"
        "def ok(self, batch, n):\n"
        "    self.state, pushed = self.ops.push(self.state, batch, n,\n"
        "                                       donate=True)\n"
        "    return self.state.size, pushed\n")
    findings = lint.lint_file(bad)
    assert _rules(findings) == ["D1"]
    assert [(f.line, f.message) for f in findings] == [
        (3, findings[0].message), (6, findings[1].message)]
    assert "donated at line 2" in findings[0].message
    assert "self.state.lo" in findings[1].message
    assert ([(f.line, f.message) for f in findings]
            == [(f.line, f.message) for f in jlint.lint_file(bad)])


def test_use_kernel_era_patterns_are_caught(tmp_path):
    bad = tmp_path / "legacy.py"
    bad.write_text(
        '"""use_kernel= and push_inplace in a docstring are fine."""\n'
        "def caller(q):\n"
        "    return steal(q, use_kernel=True)\n"
        "def push_inplace(q, batch, n):\n"
        "    return q\n")
    findings = lint.lint_file(bad)
    assert _rules(findings) == ["U1"] and len(findings) == 2


def _kernel_tree(root: Path, pkg: str, *, ref=True, ops=True, test=True):
    d = root / "src" / "repro_torch" / "kernels" / pkg
    d.mkdir(parents=True)
    (d / f"{pkg}.cu").write_text("// a kernel\n")
    if ref:
        (d / "ref.py").write_text("def plain(x):\n    return x\n")
    if ops:
        (d / "ops.py").write_text("def wrapper(x):\n    return x\n")
    tests = root / "tests"
    tests.mkdir(exist_ok=True)
    if test:
        (tests / f"test_{pkg}.py").write_text(
            f"from repro_torch.kernels.{pkg}.ops import wrapper\n")


def test_planted_incomplete_kernel_packages_are_caught(tmp_path):
    _kernel_tree(tmp_path, "good")
    _kernel_tree(tmp_path, "bare", ref=False, ops=False, test=False)
    _kernel_tree(tmp_path, "noref", ref=False)
    (tmp_path / "src/repro_torch/kernels/pyonly").mkdir()  # no .cu: exempt
    findings = lint.lint_paths([], root=tmp_path)
    assert _rules(findings) == ["K1"]
    got = sorted((f.path.split("kernels/")[1], f.message.split(" (")[0])
                 for f in findings)
    assert [path for path, _ in got] == ["bare", "bare/ops.py",
                                         "bare/ref.py", "noref/ref.py"]


def test_donation_mirror(tmp_path):
    for pkg, cu in (("queue_push", "ring_push.cu"),
                    ("queue_transfer", "ring_transfer.cu")):
        d = tmp_path / "src/repro_torch/kernels" / pkg
        d.mkdir(parents=True)
        (d / cu).write_text("// in place\n")
    core = tmp_path / "src/repro_torch/core"
    core.mkdir(parents=True)
    (core / "ops.py").write_text(
        "class BulkOps:\n"
        "    def push(self, q, batch, n, *, donate=False):\n"
        "        return q\n"
        "    def transfer(self, q, gathered, src_row, n, *, max_steal):\n"
        "        return q\n")
    findings = lint._check_donation_mirror(tmp_path)
    assert [(f.rule, "BulkOps.transfer" in f.message) for f in findings] \
        == [("K2", True)]
    (tmp_path / "src/repro_torch/kernels/queue_push/ring_push.cu").unlink()
    assert any("does not exist" in f.message
               for f in lint._check_donation_mirror(tmp_path))
    # the live tree: K2 and K4 exist and push / transfer take donate=
    assert lint._check_donation_mirror(REPO) == []
