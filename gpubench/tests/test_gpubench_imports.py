"""What the benchmark loads: run.py's import graph holds no module of JAX
or of the JAX package (``repro``; the port, ``repro_torch``, is allowed),
and the references import neither, nor the program."""
import ast
import subprocess
import sys
from pathlib import Path

from gpubench.core import card

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PROBE = """
import json, sys
sys.argv = ["gpubench/run.py"]
sys.path[:0] = [{src!r}, {root!r}]
import runpy
mod = runpy.run_path({run!r}, run_name="gpubench_probe")
mod["_paths"]()
import gpubench.drivers.prefill, gpubench.drivers.train, gpubench.control
import repro_torch.launch.train, repro_torch.launch.steps
import repro_torch.models, repro_torch.optim, repro_torch.sharding
from gpubench.core import card
print(json.dumps(card.forbidden_loaded()))
"""


def test_run_loads_no_jax():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        run=str(BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in [m for m in sys.modules
                 if m.split(".")[0] in card.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe.models", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert card.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.core_probe", object())
    assert card.forbidden_loaded() == ["repro"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                names.add(node.module.split(".")[0])
    return names


def test_references_import_neither_jax_nor_the_program():
    files = [f for d in ("reference", "core", "counts", "arch")
             for f in sorted((BENCH / d).glob("*.py"))]
    assert files
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
        assert not bad, f"{f.name} imports {bad}"


def _modules(path: Path) -> set:
    """Every module ``path`` imports, ``from a import b`` as both ``a`` and
    ``a.b``."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names |= {node.module} | {f"{node.module}.{a.name}"
                                      for a in node.names}
    return names


def test_only_a_familys_own_files_name_it():
    # the drivers, run.py, control.py and the shared modules reach a
    # family's modules through spec.family alone
    from gpubench.core import spec
    family_files = {BENCH / role / f"{p.stem}.py" for role in spec.ROLES
                    for p in (BENCH / role).glob("*.py")
                    if p.stem not in ("__init__", "work")}
    assert BENCH / "reference" / "decoder.py" in family_files
    family_modules = {f"gpubench.{f.parent.name}.{f.stem}"
                      for f in family_files}
    shared = [f for f in sorted(BENCH.rglob("*.py"))
              if f not in family_files and "tests" not in f.parts]
    shared.append(BENCH / "tests" / "tiny.py")
    assert BENCH / "run.py" in shared and BENCH / "control.py" in shared
    for f in shared:
        bad = _modules(f) & family_modules
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_run_without_the_program_fails(tmp_path):
    # a directory holding only BENCHMARK.json and gpubench/ has no program
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "mixtral-8x22b.prefill", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
