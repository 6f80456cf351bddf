"""The port imports nothing of the JAX package and nothing of JAX.

Every module of ``bammmotif2_tpu_torch/``, ``chip_smoke.py`` and the two
test helpers it loads on the card (``tests/test_torch_cuda.py``,
``tests/torch_outputs.py``) is scanned for import statements naming
``jax`` or ``bammmotif2_tpu`` (the exact name or a dotted child), and a
fresh interpreter imports all of them with both names blocked."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "bammmotif2_tpu")
HELPERS = ("chip_smoke.py", "tests/test_torch_cuda.py", "tests/torch_outputs.py")


def _port_files() -> list:
    out = []
    for d, _dirs, files in os.walk(os.path.join(ROOT, "bammmotif2_tpu_torch")):
        out += [os.path.relpath(os.path.join(d, f), ROOT) for f in files if f.endswith(".py")]
    return sorted(out) + list(HELPERS)


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def imported_names(source: str) -> list:
    """Every module name an import statement in ``source`` names."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def test_scan_finds_banned_imports():
    src = "import jax.numpy as jnp\nfrom bammmotif2_tpu.utils import fasta\nimport bammmotif2_tpu_torch\n"
    assert [n for n in imported_names(src) if _banned(n)] == [
        "jax.numpy", "bammmotif2_tpu.utils", "bammmotif2_tpu.utils.fasta"]


@pytest.mark.parametrize("rel", _port_files())
def test_no_banned_import(rel):
    with open(os.path.join(ROOT, rel)) as fh:
        bad = [n for n in imported_names(fh.read()) if _banned(n)]
    assert not bad, f"{rel} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Import every port module and load the helpers with a finder that
    raises on jax and bammmotif2_tpu."""
    code = f"""
import importlib, importlib.util, os, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in {BANNED!r}):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import bammmotif2_tpu_torch
for m in pkgutil.walk_packages(bammmotif2_tpu_torch.__path__, "bammmotif2_tpu_torch."):
    importlib.import_module(m.name)
for i, rel in enumerate({HELPERS!r}):
    spec = importlib.util.spec_from_file_location(f"helper{{i}}", os.path.join({ROOT!r}, rel))
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules if n.split(".")[0] in {BANNED!r})
assert not bad, bad
print("imported")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
