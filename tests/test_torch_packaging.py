"""``pyproject.toml`` installs the whole port: every directory of
``repic_tpu_torch`` with an ``__init__.py`` is a listed package, and the
files it loads at run time (CUDA and C++ sources, the examples
manifest) are package data."""

import fnmatch
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setuptools():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]


def test_every_port_package_is_listed():
    listed = set(_setuptools()["packages"])
    root = os.path.join(REPO, "repic_tpu_torch")
    found = set()
    for d, _, files in os.walk(root):
        if "__init__.py" in files and "__pycache__" not in d:
            rel = os.path.relpath(d, REPO)
            found.add(rel.replace(os.sep, "."))
    assert "repic_tpu_torch.models" in found
    assert found - listed == set(), sorted(found - listed)


def test_runtime_files_are_package_data():
    data = _setuptools()["package-data"]
    root = os.path.join(REPO, "repic_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith((".cu", ".cuh", ".cpp", ".json")):
                continue
            pkg_dir = d
            while not os.path.isfile(os.path.join(pkg_dir, "__init__.py")):
                pkg_dir = os.path.dirname(pkg_dir)
            pkg = os.path.relpath(pkg_dir, REPO).replace(os.sep, ".")
            rel = os.path.relpath(os.path.join(d, f), pkg_dir)
            assert any(fnmatch.fnmatch(rel, pat)
                       for pat in data.get(pkg, [])), (pkg, rel)
