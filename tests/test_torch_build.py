"""The C interfaces of the port's CUDA sources against their bindings.

``repic_tpu_torch/_build.py`` binds every exported function of
``csrc/*.cu`` with :mod:`ctypes` from a list of argument kinds.  A
mismatch would pass garbage at launch on the card, where nothing here
can compile or run the source, so this file parses each ``extern "C"``
definition and holds its parameter list to the binding: the same count,
a pointer where the binding says ``p``, an ``int`` for ``i``, a
``float`` for ``f``.
"""

import os
import re

import pytest

from repic_tpu_torch import _build

_KIND = {"p": r"(const )?void\*", "i": r"int", "f": r"float"}


def _exported(name: str) -> dict:
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        src = f.read()
    out = {}
    for fn, params in re.findall(
        r'extern "C" int (\w+)\(([^)]*)\)', src
    ):
        out[fn] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_c_interface_matches_ctypes_binding(name):
    exported = _exported(name)
    assert set(exported) == set(_build.KERNELS[name])
    for fn, kinds in _build.KERNELS[name].items():
        params = exported[fn]
        assert len(params) == len(kinds), fn
        for i, (ctype, kind) in enumerate(zip(params, kinds)):
            assert re.fullmatch(_KIND[kind], ctype), (fn, i, ctype, kind)
