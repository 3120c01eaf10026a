"""Run the JAX package's analysis test cases against both packages and
compare what the two linters found.

:func:`run_recorded` runs one case of a reference test file twice
(``tests/torch_twin.py: load_twin``): as written against
``repic_tpu.analysis`` and renamed against ``repic_tpu_torch.analysis``.
The case's own assertions hold for each.  While it runs, the named
analysis entry points of the twin module (``run_concurrency``,
``analyze_source``, ...) are wrapped to record every list of findings
they return, so the caller can hold the two packages' findings equal
as sets of (rule, line, column): the paths differ (each package's case
runs in a directory of its own), the verdicts must not.

:func:`paired` is the other half: for a rule re-derived for torch, the
JAX idiom and the torch idiom are written with the same line layout and
each goes through its own package.
"""

from __future__ import annotations

import functools
import os
import textwrap

import pytest
from torch_twin import PKGS, load_twin, run_case

PACKAGE = {"jax": "repic_tpu", "port": "repic_tpu_torch"}


def triples(findings) -> set:
    return {(f.rule, f.line, f.col) for f in findings}


def _flat(recorded) -> list:
    out = []
    for r in recorded:
        out.extend(getattr(r, "findings", r))
    return out


def run_recorded(test_file, name, tmp_path, record, args=(), subs=(),
                 capsys=None) -> dict:
    """Run case ``name`` of ``tests/<test_file>`` for both packages
    (``tmp_path/<pkg>`` as its ``tmp_path``; ``args`` for a
    parametrized case) and return ``{pkg: [findings]}``: everything the
    twin's ``record`` functions returned meanwhile."""
    out = {}
    for pkg in PKGS:
        mod = load_twin(test_file, pkg, subs if pkg == "port" else ())
        seen: list = []
        saved = {}
        for fn_name in record:
            orig = mod.__dict__[fn_name]

            @functools.wraps(orig)
            def rec(*a, _orig=orig, **k):
                r = _orig(*a, **k)
                seen.append(r)
                return r

            saved[fn_name] = orig
            mod.__dict__[fn_name] = rec
        try:
            if args:
                getattr(mod, name)(*args)
            else:
                run_case(mod, name, os.path.join(str(tmp_path), pkg),
                         capsys)
        finally:
            mod.__dict__.update(saved)
        out[pkg] = _flat(r for r in seen
                         if isinstance(r, list) or hasattr(r, "findings"))
    return out


def assert_same(recorded: dict) -> None:
    assert triples(recorded["port"]) == triples(recorded["jax"]), (
        [f.format() for f in recorded["jax"]],
        [f.format() for f in recorded["port"]],
    )


def write(root, name, source) -> str:
    path = os.path.join(str(root), name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(textwrap.dedent(source).lstrip("\n"))
    return path


def paired(pair: dict, tmp_path, run, name="mod.py") -> dict:
    """Write each package's snippet of ``pair`` under ``tmp_path/<pkg>``
    and run that package's ``run(pkg, path)``; returns ``{pkg:
    findings}`` after checking the two snippets share their layout."""
    jl = textwrap.dedent(pair["jax"]).lstrip("\n").count("\n")
    pl = textwrap.dedent(pair["port"]).lstrip("\n").count("\n")
    assert jl == pl, "the two idioms must have the same line layout"
    return {pkg: run(pkg, write(os.path.join(str(tmp_path), pkg), name,
                                pair[pkg]))
            for pkg in PKGS}


def case_params(cases: dict) -> list:
    return [pytest.param(k, id=k) for k in sorted(cases)]
