"""The port package imports nothing of JAX, flax or the JAX package."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "isaacgymenvs_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "isaacgymenvs_tpu")
# `_build/` holds what is built at run time (kernel libraries, unpacked
# copies of the tree), not sources of the port
SOURCES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in SOURCES}
    assert {"fused.py", "vec_task.py", "ppo.py", "chip_smoke.py"} <= names
