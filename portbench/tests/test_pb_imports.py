"""Nothing the benchmark runs imports JAX, its libraries or the JAX
package (top-level names compared whole, so ``repro_torch`` passes), and
nothing under ``portbench/reference`` imports the program."""
import ast
import subprocess
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        bad = {n for n in _imports(path) if n.split(".")[0] in FORBIDDEN}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        bad = {n for n in _imports(path)
               if n.split(".")[0] in FORBIDDEN | {"repro_torch"}}
        assert not bad, (path, bad)


def test_a_run_loads_no_jax_module():
    """Every module of the benchmark and what it loads, in a fresh
    process, then a cell run whole at smoke size: ``sys.modules`` holds
    none of the forbidden top-level names."""
    code = f"""
import sys, importlib, pathlib
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from portbench.harness import runtime
for p in pathlib.Path({str(PORTBENCH)!r}).rglob('*.py'):
    if 'tests' in p.parts:
        continue
    runtime.load_module(p, 'x_' + str(abs(hash(str(p)))))
from portbench.tests.pb_smoke import run_smoke
run_smoke('xlstm-125m.consensus', seconds=0.2)
print(runtime.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
