"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (``bammmotif2_tpu_torch`` is not
``bammmotif2_tpu``), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest
from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bammmotif2_tpu"}
PROGRAM = "bammmotif2_tpu_torch"


def modules(sub: str = "") -> list:
    out = []
    for dirpath, _dirs, files in os.walk(os.path.join(BENCH_DIR, sub)):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def imported(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                names.add(arg.values[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", modules("reference"), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_imports_no_program(path):
    names = imported(path)
    assert PROGRAM not in names and not names & FORBIDDEN
    assert names <= {"__future__", "json", "os", "warnings", "numpy", "torch", "reference"}


def test_top_level_names_are_compared_whole(monkeypatch):
    import run

    fake = {"bammmotif2_tpu_torch": None, "bammmotif2_tpu_torch.cli": None, "jaxtyping": None,
            "numpy": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**fake, "jax.numpy": None, "bammmotif2_tpu.cli": None})
    assert run.forbidden_modules() == ["bammmotif2_tpu", "jax"]


def test_a_run_loads_no_jax():
    """A tiny run of each cell on the CPU, in a process of its own, holds
    no module of JAX or of the JAX package once its window has closed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import conftest, run\n"
        "for name in conftest.TINY:\n"
        "    run.bench_run(conftest.tiny_cell(name), 7, 0.1, False, 'cpu')\n"
        "print(run.forbidden_modules())\n"
    ) % (os.path.join(BENCH_DIR, "tests"), BENCH_DIR, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
