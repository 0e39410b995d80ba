"""Static invariant lint for the port's kernel and backend conventions
(AST only; PyTorch port of ``repro.analysis.lint``).

The pass walks the source tree **without executing anything** and checks:

``K1`` — kernel-package completeness
    Every package under ``src/repro_torch/kernels/`` that ships a CUDA
    source (``*.cu``) must ship (a) its plain PyTorch version, a
    ``ref.py`` defining at least one function, (b) the wrapper that
    dispatches between them, ``ops.py``, and (c) a parity test: some file
    under ``tests/`` names ``repro_torch.kernels.<pkg>``.

``K2`` — donation mirror
    The in-place kernels (K2 ``queue_push/ring_push.cu`` and K4
    ``queue_transfer/ring_transfer.cu``) write the caller's ring, which is
    only sound where the caller asked for it: the ``BulkOps`` methods they
    serve (``push``, ``transfer``) must expose a ``donate`` keyword.

``D1`` — use-after-donate
    A value passed as the queue-state argument of a ``donate=True`` call
    must not be read again in the same scope before being rebound: the
    ring was written in place.  The scan is linear per function scope,
    models execution order inside a statement (values load before
    targets bind, so ``q, out = ops.push(q, ..., donate=True)`` is
    clean), and tracks dotted names (``self.state``).

``U1`` — ``use_kernel``-era patterns
    The pre-BulkOps dialect (``use_kernel=`` keywords, ``*_inplace``
    function names) must not reappear.  Docstrings and comments are
    exempt (AST).

CLI::

    python -m repro_torch.analysis.lint [paths...]
    # default: src/repro_torch scripts chip_smoke.py

Exit status 1 iff any finding.
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional

__all__ = ["Finding", "lint_paths", "lint_file", "main"]

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_PATHS = ("src/repro_torch", "scripts", "chip_smoke.py")

# K2: the kernels that write the caller's ring in place, and the BulkOps
# methods each serves, which must then expose donate=.
IN_PLACE_KERNELS = {
    "queue_push/ring_push.cu": ("push",),
    "queue_transfer/ring_transfer.cu": ("transfer",),
}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _parse(path: Path) -> Optional[ast.Module]:
    try:
        return ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``a`` / ``a.b.c`` -> dotted name string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _rel(path: Path) -> str:
    try:
        return str(path.relative_to(REPO_ROOT))
    except ValueError:
        return str(path)


# ---------------------------------------------------------------------------
# K1: kernel-package completeness
# ---------------------------------------------------------------------------


def _kernels_dir(root: Path) -> Path:
    return root / "src" / "repro_torch" / "kernels"


def _check_kernel_packages(root: Path, tests_dir: Path) -> List[Finding]:
    kernels = _kernels_dir(root)
    if not kernels.is_dir():
        return []
    test_text = "".join(p.read_text() for p in sorted(tests_dir.glob("**/*.py"))) \
        if tests_dir.is_dir() else ""
    out: List[Finding] = []
    for pkg in sorted(p for p in kernels.iterdir() if p.is_dir()):
        if not any(pkg.glob("*.cu")):
            continue
        ref_py = pkg / "ref.py"
        ref_tree = _parse(ref_py) if ref_py.is_file() else None
        if ref_tree is None or not any(
                isinstance(n, ast.FunctionDef) for n in ast.walk(ref_tree)):
            out.append(Finding(
                "K1", _rel(ref_py), 1,
                f"kernel package '{pkg.name}' ships no plain PyTorch version "
                f"(ref.py missing or defines no function)"))
        if not (pkg / "ops.py").is_file():
            out.append(Finding(
                "K1", _rel(pkg / "ops.py"), 1,
                f"kernel package '{pkg.name}' ships no wrapper (ops.py) to "
                f"dispatch between its kernel and its plain version"))
        if f"repro_torch.kernels.{pkg.name}" not in test_text:
            out.append(Finding(
                "K1", _rel(pkg), 1,
                f"kernel package '{pkg.name}' has no parity test (nothing "
                f"under tests/ names repro_torch.kernels.{pkg.name})"))
    return out


# ---------------------------------------------------------------------------
# K2: in-place kernels <-> donate mirror
# ---------------------------------------------------------------------------


def _bulkops_donate_kwargs(ops_py: Path) -> set:
    """Names of BulkOps methods exposing a ``donate`` keyword."""
    tree = _parse(ops_py)
    out: set = set()
    if tree is None:
        return out
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "BulkOps":
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and any(
                        a.arg == "donate" for a in fn.args.kwonlyargs + fn.args.args):
                    out.add(fn.name)
    return out


def _check_donation_mirror(root: Path) -> List[Finding]:
    kernels = _kernels_dir(root)
    ops_py = root / "src" / "repro_torch" / "core" / "ops.py"
    if not (kernels.is_dir() and ops_py.is_file()):
        return []
    donate_kwargs = _bulkops_donate_kwargs(ops_py)
    out: List[Finding] = []
    for source, served in sorted(IN_PLACE_KERNELS.items()):
        cu = kernels / source
        if not cu.is_file():
            out.append(Finding(
                "K2", _rel(cu), 1,
                f"IN_PLACE_KERNELS names '{source}', which does not exist "
                f"— keep the lint's table of in-place kernels current"))
            continue
        for op in served:
            if op not in donate_kwargs:
                out.append(Finding(
                    "K2", _rel(ops_py), 1,
                    f"kernel '{source}' writes its ring in place but "
                    f"BulkOps.{op} exposes no donate= keyword"))
    return out


# ---------------------------------------------------------------------------
# D1: use-after-donate
# ---------------------------------------------------------------------------


class _ScopeScanner:
    """Linear event scan of one function scope (or module top level).

    Events, in execution order: ``load(name)``, ``donate(name)``,
    ``bind(name)``.  Inside a statement, value expressions emit their
    loads (and donates) before assignment targets bind — so the idiom
    ``q, out = ops.push(q, batch, n, donate=True)`` donates then
    immediately rebinds and stays clean, while a later bare read of a
    still-donated name is flagged.
    """

    def __init__(self, path: str):
        self.path = path
        self.donated: dict = {}  # dotted name -> donate lineno
        self.findings: List[Finding] = []

    # -- events --

    def load(self, name: str, line: int) -> None:
        for don, dline in self.donated.items():
            if name == don or name.startswith(don + "."):
                self.findings.append(Finding(
                    "D1", self.path, line,
                    f"'{name}' is read after being donated at line {dline} "
                    f"(donate=True aliases the buffer in place; rebind the "
                    f"name from the op's return value first)"))

    def donate(self, name: str, line: int) -> None:
        self.donated[name] = line

    def bind(self, name: str) -> None:
        self.donated.pop(name, None)

    # -- expression walk (loads + donates, execution order) --

    def expr(self, node: ast.AST) -> None:
        if node is None:
            return
        dotted = _dotted(node)
        if dotted is not None and isinstance(getattr(node, "ctx", None), ast.Load):
            self.load(dotted, node.lineno)
            return  # a.b.c counted once, not per attribute level
        if isinstance(node, ast.Call):
            self.expr(node.func)
            for a in node.args:
                self.expr(a)
            for kw in node.keywords:
                self.expr(kw.value)
            donate_kw = next(
                (kw for kw in node.keywords if kw.arg == "donate"), None)
            if donate_kw is not None and not (
                    isinstance(donate_kw.value, ast.Constant)
                    and donate_kw.value.value is False) and node.args:
                target = _dotted(node.args[0])
                if target is not None:
                    self.donate(target, node.lineno)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            return  # separate scope
        for child in ast.iter_child_nodes(node):
            self.expr(child)

    # -- statement walk --

    def bind_target(self, node: ast.AST) -> None:
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                self.bind_target(elt)
            return
        if isinstance(node, ast.Starred):
            self.bind_target(node.value)
            return
        dotted = _dotted(node)
        if dotted is not None:
            self.bind(dotted)
        else:  # subscript etc: value part is a load
            self.expr(node)

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested scope scanned separately
        if isinstance(node, ast.Assign):
            self.expr(node.value)
            for t in node.targets:
                self.bind_target(t)
            return
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            self.expr(node.value)
            self.bind_target(node.target)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self.expr(node.iter)
            self.bind_target(node.target)
            for s in node.body + node.orelse:
                self.stmt(s)
            return
        if isinstance(node, (ast.If, ast.While)):
            self.expr(node.test)
            for s in node.body + node.orelse:
                self.stmt(s)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self.expr(item.context_expr)
                if item.optional_vars is not None:
                    self.bind_target(item.optional_vars)
            for s in node.body:
                self.stmt(s)
            return
        if isinstance(node, ast.Try):
            for s in node.body + node.orelse + node.finalbody:
                self.stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self.stmt(s)
            return
        # Return / Expr / Assert / Raise / Delete / ...: walk expressions
        for child in ast.iter_child_nodes(node):
            self.expr(child)


def _check_use_after_donate(path: Path, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    scopes: List[List[ast.stmt]] = [list(tree.body)]
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scopes.append(list(node.body))
    for body in scopes:
        sc = _ScopeScanner(_rel(path))
        for stmt in body:
            sc.stmt(stmt)
        findings.extend(sc.findings)
    return findings


# ---------------------------------------------------------------------------
# U1: use_kernel-era patterns
# ---------------------------------------------------------------------------


def _check_use_kernel_era(path: Path, tree: ast.Module) -> List[Finding]:
    out: List[Finding] = []
    rel = _rel(path)
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "use_kernel":
            out.append(Finding(
                "U1", rel, node.value.lineno,
                "use_kernel= keyword — the flag dialect is gone; "
                "construct a backend with make_ops(...) instead"))
        if isinstance(node, ast.FunctionDef) and node.name.endswith("_inplace"):
            out.append(Finding(
                "U1", rel, node.lineno,
                f"'{node.name}' — *_inplace variants are gone; "
                f"use the backend's donate=True call shape"))
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                if alias.name.endswith("_inplace"):
                    out.append(Finding(
                        "U1", rel, node.lineno,
                        f"import of '{alias.name}' — *_inplace variants are "
                        f"gone"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_file(path: Path) -> List[Finding]:
    """Per-file rules only (D1, U1)."""
    tree = _parse(path)
    if tree is None:
        return [Finding("E0", _rel(path), 1, "file does not parse")]
    return _check_use_after_donate(path, tree) + _check_use_kernel_era(path, tree)


def lint_paths(paths: Iterable[Path], *, root: Path = REPO_ROOT) -> List[Finding]:
    findings: List[Finding] = []
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files.extend(sorted(p.glob("**/*.py")))
        elif p.is_file():
            files.append(p)
    for f in files:
        findings.extend(lint_file(f))
    findings.extend(_check_kernel_packages(root, root / "tests"))
    findings.extend(_check_donation_mirror(root))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths = [Path(a) for a in argv] if argv else [
        REPO_ROOT / d for d in DEFAULT_PATHS]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    n_files = sum(len(list(Path(p).glob('**/*.py'))) if Path(p).is_dir() else 1
                  for p in paths)
    if findings:
        print(f"lint: {len(findings)} finding(s) across {n_files} file(s)")
        return 1
    print(f"lint: clean ({n_files} file(s))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
