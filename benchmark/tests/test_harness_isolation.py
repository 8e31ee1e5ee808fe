"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program: module names compared whole by their
top-level part (the port's name begins with the JAX package's)."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO

BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "latentblending_tpu"}
PORT = "latentblending_tpu_torch"


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert PORT not in _imports(path), path


def test_only_the_system_module_and_tests_import_the_program():
    """The program is imported by the system module, the architectures'
    system modules (benchmark/systems/) and tests alone."""
    users = {os.path.relpath(p, BENCH) for p in _sources() if PORT in _imports(p)}
    others = {u for u in users if not u.startswith(("tests" + os.sep, "systems" + os.sep))}
    assert others <= {"system.py"}, others
    assert any(u.startswith("systems" + os.sep) for u in users)


@pytest.mark.parametrize("kind", ["systems", "reference", "yardstick"])
def test_an_unknown_architecture_is_refused_naming_its_module(kind):
    from benchmark import architecture

    cfg = {"name": "c", "architecture": "nowhere"}
    with pytest.raises(ValueError, match=f"benchmark/{kind}/nowhere.py"):
        architecture.load(kind, cfg)
    with pytest.raises(ValueError, match=f"benchmark/{kind}/nowhere.py"):
        architecture.check(cfg)


def test_a_cell_of_an_unknown_architecture_is_refused_at_set_up(tmp_path):
    import json

    from benchmark import run
    from benchmark.tests.tiny import tiny_root

    bench = tiny_root(str(tmp_path), {"t.turbo": ("turbo", "transition")})
    path = tmp_path / "benchmark" / "configs" / "tiny-turbo.json"
    cfg = json.loads(path.read_text())
    path.write_text(json.dumps(dict(cfg, architecture="nowhere")))
    with pytest.raises(ValueError, match="benchmark/systems/nowhere.py.*benchmark/reference/nowhere.py"):
        run.run_cell(bench, "t.turbo", 1, 0.0, False, "cpu", root=str(tmp_path))


def test_nothing_reads_the_jax_harness():
    for path in _sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        text = open(path).read()
        for word in ("bench.py", "tools/", "BENCH_", "BASELINE"):
            assert word not in text, f"{path} names {word}"


def test_a_run_loads_no_forbidden_module():
    """Import every module a run imports, the program's included, in a fresh
    interpreter, and look at sys.modules."""
    code = ("import sys, benchmark.run, benchmark.check, benchmark.system, benchmark.calibrate, "
            "benchmark.trace, benchmark.traffic, benchmark.systems.sdxl, benchmark.reference.sdxl, "
            "benchmark.yardstick.sdxl\n"
            "import benchmark.metrics.mfu\n"
            "from latentblending_tpu_torch.engine.blending import BlendingEngine\n"
            "print(sorted({n.split('.')[0] for n in sys.modules} & %r))" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
