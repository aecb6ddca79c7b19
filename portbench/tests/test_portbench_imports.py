"""Nothing the benchmark imports is JAX or the JAX package, and the
reference imports nothing of the program either (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "optax", "border_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE / "reference")))
def test_reference_imports_nothing_of_the_program(path):
    assert "border_tpu_torch" not in set(top_level_imports(path))


def test_loaded_modules_of_the_reference_and_harness():
    code = ("import sys, json; import portbench.run, portbench.calibrate; "
            "from portbench.reference import checks, games, kinds; "
            "cfgs = [json.load(open(c['file'])) for c in json.load(open('BENCHMARK.json'))"
            "['configs']]; "
            "[(checks.find(c), kinds.find(c), games.find(c['env'])) for c in cfgs]; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'optax', 'border_tpu', "
            "'border_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
