"""The port stands alone: importing every module of pilosa_tpu_torch (and
chip_smoke.py's imports) pulls in neither jax nor any pilosa_tpu module.
Checked in a fresh interpreter — this test process already imported jax
(tests/conftest.py) — and by an AST scan of the sources."""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "pilosa_tpu_torch"


def _forbidden(name):
    """jax, jax.*, pilosa_tpu, pilosa_tpu.* — but not pilosa_tpu_torch."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pilosa_tpu")


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("pilosa_tpu", True),
    ("pilosa_tpu.pql", True), ("pilosa_tpu_torch", False),
    ("pilosa_tpu_torch.ops.kernels", False), ("jaxtyping", False),
])
def test_guard_tells_the_port_from_the_reference(name, bad):
    assert _forbidden(name) is bad


def test_importing_every_port_module_loads_no_jax():
    code = """
import importlib, json, pkgutil, sys
import pilosa_tpu_torch
for m in pkgutil.walk_packages(pilosa_tpu_torch.__path__, "pilosa_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps(sorted(sys.modules)))
"""
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pilosa_tpu_torch.executor" in mods
    assert "pilosa_tpu_torch.ops.kernels" in mods
    assert [m for m in mods if _forbidden(m)] == []


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_sources_name_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {name}"
           for p in files for line, name in _imports(p) if _forbidden(name)]
    assert bad == []
