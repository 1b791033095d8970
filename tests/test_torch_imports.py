"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or its
``benchmarks`` scripts (the card's machine has no jax; the port keeps
copies of what it needs, ``bench/summarize_claims.py`` too).  Checked by
parsing every file, so an import inside a function is caught too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def forbidden_imports(source: str) -> list:
    """``(line, module)`` of every import of ``jax...``, ``repro...``
    (but ``repro_torch...``) or ``benchmarks...`` in ``source``."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "benchmarks"):
                out.append((node.lineno, name))
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    assert forbidden_imports(path.read_text()) == []


def test_the_guard_catches_each_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom jax import lax\n"
           "from repro.core import bafdp\nimport repro\n"
           "def f():\n    from repro.kernels import ref\n"
           "import repro_torch\nfrom repro_torch.core import bafdp\n"
           "from . import tree\nimport numpy\n"
           "from benchmarks import summarize_claims\n")
    assert [m for _, m in forbidden_imports(src)] == [
        "jax", "jax.numpy", "jax", "repro.core", "repro", "benchmarks",
        "repro.kernels"]
    assert len(FILES) > 40
