"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the port in the reference.  Module names are
compared by their top-level part, whole: the port's name begins with the
JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "imagined_speech_translation_tpu"}
PORT = "imagined_speech_translation_tpu_torch"


def imported(path: Path) -> set[str]:
    """Top-level names of the modules ``path`` imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & JAX


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    """The reference reads only PyTorch, NumPy, SciPy, the standard library
    and its own modules (relative imports that stay in its folder)."""
    tree = ast.parse(path.read_text())
    assert PORT not in imported(path)
    assert "portbench" not in imported(path)
    assert all(n.level <= 1 for n in ast.walk(tree) if isinstance(n, ast.ImportFrom))


def test_top_level_names_are_compared_whole():
    """The port's name begins with the JAX package's and is not it."""
    from portbench.run import FORBIDDEN

    assert PORT.startswith("imagined_speech_translation_tpu")
    assert PORT.split(".")[0] not in FORBIDDEN


def test_a_run_loads_nothing_of_jax():
    """A tiny run on the CPU in a fresh process, then ``sys.modules``."""
    code = (
        "import sys, json, tempfile, torch\n"
        "from portbench.tests.tiny import make_root\n"
        "from portbench import run\n"
        "root = make_root(tempfile.mkdtemp())\n"
        "run.run_cell('serve-tiny', 5, 0, False, torch.device('cpu'), root=root)\n"
        "print(json.dumps(run.loaded_forbidden()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
