"""The port's packaging: its public names, the native codec source it ships
and its console script, as ``pyproject.toml`` declares them."""

import glob
import importlib
import os
import tomllib

from setuptools import find_packages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pyproject() -> dict:
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)


def test_public_names():
    import bammmotif2_tpu_torch
    from bammmotif2_tpu_torch.utils.alphabet import Alphabet
    from bammmotif2_tpu_torch.utils.config import Params

    assert bammmotif2_tpu_torch.Alphabet is Alphabet
    assert bammmotif2_tpu_torch.Params is Params
    assert set(bammmotif2_tpu_torch.__all__) == {"Alphabet", "Params", "__version__"}


def test_package_data_ships_the_codec_source():
    """setuptools finds the port's io package, and its package-data globs
    (relative to the package's directory) take io/fasta_codec.cpp and the
    CUDA sources."""
    tool = _pyproject()["tool"]["setuptools"]
    packages = find_packages(where=ROOT, include=tool["packages"]["find"]["include"])
    assert {"bammmotif2_tpu_torch", "bammmotif2_tpu_torch.io"} <= set(packages)

    def shipped(pkg: str) -> set:
        pkg_dir = os.path.join(ROOT, *pkg.split("."))
        return {os.path.relpath(f, os.path.join(ROOT, "bammmotif2_tpu_torch"))
                for pat in tool["package-data"].get(pkg, ())
                for f in glob.glob(os.path.join(pkg_dir, pat))}

    assert "io/fasta_codec.cpp" in shipped("bammmotif2_tpu_torch.io")
    assert "csrc/em_counts.cu" in shipped("bammmotif2_tpu_torch")
    # the reference's lines stay
    assert tool["package-data"]["bammmotif2_tpu.io"] == ["*.cpp"]


def test_console_scripts():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["bammmotif2-tpu"] == "bammmotif2_tpu.cli:main"
    target = scripts["bammmotif2-tpu-torch"]
    assert target == "bammmotif2_tpu_torch.cli:main"
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn))
