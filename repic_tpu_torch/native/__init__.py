"""The port's host C++ cores, built with ``g++`` at first use.

* ``setpack.cpp`` — exact maximum-weight set packing (component
  decomposition + branch-and-bound), the ``exact`` rung;
* ``boxparse.cpp`` — the BOX-file row parser, the first tier of
  :func:`repic_tpu_torch.utils.box_io.read_box`.

Each source compiles (``g++ -O2 -std=c++17 -shared -fPIC``) into
``build/repic_tpu_torch/`` at the repository root, named by a hash of
the source and the flags, and is loaded with :mod:`ctypes`.  A missing
compiler or a failed build raises: nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "repic_tpu_torch"
)
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict = {}


def _lib_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(_HERE, stem + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def _build(stem: str) -> str:
    """The library's path, compiled first when it is not on disk; the
    build or the cached load is counted by the telemetry probes."""
    from repic_tpu_torch.telemetry import probes

    t0 = time.perf_counter()
    out = _lib_path(stem)
    if os.path.exists(out):
        probes.note_cached_load(time.perf_counter() - t0)
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            f"g++ not found: native/{stem}.cpp is compiled at first use"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    # a one-time build at first use, cached on disk after: holding the
    # module lock across it keeps two threads from building one stem
    proc = subprocess.run(  # repic: noqa[RT303]
        [cxx, *CXX_FLAGS, os.path.join(_HERE, stem + ".cpp"), "-o", tmp],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed for native/{stem}.cpp:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    probes.note_build(time.perf_counter() - t0)
    return out


def _load(stem: str, fn_name: str, argtypes, restype) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(_build(stem))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
            _LIBS[stem] = lib
        return lib


def _setpack():
    return _load("setpack", "setpack_solve", [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ], ctypes.c_int32)


def _boxparse():
    return _load("boxparse", "boxparse_rows", [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
    ], ctypes.c_long)


def parse_box_native(data: bytes) -> np.ndarray | None:
    """Raw BOX-file bytes -> ``(n, 5)`` float64 rows ``x, y, w, h,
    conf`` (short rows get w = h = 0, conf = 1).  None when the file
    needs the line loop (an odd header, a bad token, a short row)."""
    lib = _boxparse()
    # rows end in \n or \r (universal newlines)
    max_rows = data.count(b"\n") + data.count(b"\r") + 2
    out = np.empty((max_rows, 5), dtype=np.float64)
    # c_char_p NUL-terminates (strtod may peek one past the last token)
    n = lib.boxparse_rows(
        ctypes.c_char_p(data),
        ctypes.c_long(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(max_rows),
    )
    if n < 0:
        return None
    return out[:n]


def solve_exact_native(
    member_vertex: np.ndarray,
    w: np.ndarray,
    *,
    node_limit: int = 2_000_000,
    fallback_log: list | None = None,
) -> np.ndarray:
    """Exact maximum-weight set packing through the C++ core; the
    contract of :func:`repic_tpu_torch.ops.solver.solve_exact_py`.
    ``fallback_log`` gets one ``{"components": n}`` entry when ``n``
    components hit the node limit and fell back to greedy."""
    lib = _setpack()
    src = np.asarray(member_vertex)
    if src.size and (src.min() < 0 or src.max() >= np.iinfo(np.int32).max):
        raise ValueError(
            "vertex ids must be in [0, 2**31-1); got range "
            f"[{src.min()}, {src.max()}]"
        )
    mv = np.ascontiguousarray(src, dtype=np.int32)
    ww = np.ascontiguousarray(w, dtype=np.float64)
    if mv.ndim != 2 or len(ww) != mv.shape[0]:
        raise ValueError(f"bad shapes: member_vertex {mv.shape}, w {ww.shape}")
    c, k = mv.shape
    out = np.zeros(c, dtype=np.uint8)
    rc = lib.setpack_solve(
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ww.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(c),
        ctypes.c_int32(k),
        ctypes.c_int64(node_limit),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        raise RuntimeError(f"setpack_solve failed with rc={rc}")
    if rc > 0 and fallback_log is not None:
        fallback_log.append({"components": int(rc)})
    return out.astype(bool)
