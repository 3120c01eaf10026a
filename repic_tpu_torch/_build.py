"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with :mod:`ctypes` — no PyTorch headers, so
a build takes seconds.  Libraries land in ``build/repic_tpu_torch/``
at the repository root, named by a hash of the source, the shared
headers and the flags, so a changed source or header rebuilds and an
unchanged one loads at once.  :func:`build_all` starts one ``nvcc``
per source, all at the same time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` — no
implicit fused multiply-add, so every float expression rounds the way
the plain PyTorch version rounds it; where the reference program does
fuse (the dual price step), the source says ``fmaf`` explicitly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build", "repic_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: source basename -> C functions it exports: name -> argtypes
KERNELS = {
    "neighbors": {
        "repic_topk_neighbors": (
            ["p"] * 5 + ["f", "p", "f"] + ["p"] * 3 + ["i"] * 4 + ["f", "p"]
        ),
    },
    "cliques": {
        "repic_clique_count": ["p"] * 8 + ["i"] * 4 + ["f", "p"],
        "repic_clique_write": ["p"] * 18 + ["i"] * 5 + ["f", "p"],
    },
    "dual": {
        "repic_dual_smem_bytes": ["i", "i", "i"],
        "repic_dual_solve": ["p"] * 6 + ["i"] * 6 + ["f", "p"],
    },
    "ascent": {
        "repic_dual_ascent_smem_bytes": ["i"] * 5,
        "repic_dual_ascent_slice_bytes": ["i"] * 5,
        "repic_dual_ascent": ["p"] * 8 + ["i"] * 7 + ["f", "p"],
    },
}

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_LIBS: dict = {}
#: sources this process compiled (a later load of one is no cache hit)
_BUILT: set = set()
_LOCK = threading.Lock()
#: ptxas register/shared-memory report of each build, by source
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use "
        "and need the CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc build; returns (proc, tmp, out, start time) or
    None when the library already exists."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    t0 = time.perf_counter()
    # a one-time build at first use, cached on disk after: holding the
    # module lock across it keeps two threads from building one source
    proc = subprocess.Popen(  # repic: noqa[RT303]
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out, t0


def _finish(name: str, started) -> None:
    if started is None:
        return
    from repic_tpu_torch.telemetry import probes

    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    _BUILT.add(name)
    probes.note_build(time.perf_counter() - t0)


def build_all() -> dict:
    """Compile every kernel source (in parallel) and load them all;
    returns ``{source: ctypes.CDLL}``."""
    with _LOCK:
        todo = [n for n in KERNELS if n not in _LIBS]
        started = {n: _start(n) for n in todo}
        for n in todo:
            _finish(n, started[n])
    return {n: load(n) for n in KERNELS}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    Loading a library built by an earlier process counts as a
    persistent-cache hit (:mod:`repic_tpu_torch.telemetry.probes`)."""
    from repic_tpu_torch.telemetry import probes

    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        t0 = time.perf_counter()
        _finish(name, _start(name))
        lib = ctypes.CDLL(_lib_path(name))
        if name not in _BUILT:
            probes.note_cached_load(time.perf_counter() - t0)
        for fn, kinds in KERNELS[name].items():
            f = getattr(lib, fn)
            f.argtypes = [_CTYPES[k] for k in kinds]
            f.restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels read ``xy``
    as ``float2``), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
