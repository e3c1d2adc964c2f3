"""What the benchmark loads: no module whose top-level name (compared
whole: the port's name begins with the JAX package's) is ``jax``,
``jaxlib``, ``flax`` or ``fp8_quantization_tpu``; and nothing of the port
in the plain reference."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = harness.BENCH
PORT = "fp8_quantization_tpu_torch"


def _imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return [p for p in sorted(BENCH.rglob("*.py")) if "__pycache__" not in p.parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not _imported(path) & set(harness.FORBIDDEN)


def test_whole_name_compare():
    sys.modules.setdefault("fp8_quantization_tpu_torch_probe", None)
    try:
        assert "fp8_quantization_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("fp8_quantization_tpu_torch_probe", None)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _imported(path)
    # of the benchmark, only the reference itself (the harness imports the port)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference"), node.module


def test_loaded_modules_of_a_run():
    """A tiny CPU run (the ResNet cell at 32x32, two images a batch) loads
    no forbidden module; the reference, imported alone, loads nothing of
    the port."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import harness
import benchmark.reference.resnet, benchmark.reference.vit
assert not [m for m in sys.modules if m.split('.')[0] == {PORT!r}]
from benchmark.tests.tiny import tiny_run
result = tiny_run('r50_fp8.b256', traced=True)
assert result is not None
print('FORBIDDEN', harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
