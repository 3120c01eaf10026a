"""Kernel contracts: the RT42x pack (the port of
``repic_tpu.analysis.kernels``).

A hand-written kernel declares, beside its entry's
:class:`~repic_tpu_torch.analysis.contracts.Contract`, a
:class:`KernelContract`: the shape ladder the chunk path pads to, a
function making concrete probe inputs, the unfused path it replaced
(the reference), a comparator and a tolerance.
:func:`differential_probe` runs kernel and reference on one rung's
inputs on a named device and returns the disagreements; KERNELCHECK
(:mod:`repic_tpu_torch.analysis.kernelcheck`) runs it over every rung
of every registered kernel, and ``check``
(:mod:`repic_tpu_torch.analysis.semantic`) runs :func:`run_kernel_checks`
for every kernel entry:

RT423  the kernel's output tree -- arity, shapes, dtypes -- against the
       reference's, on the ladder's first rung: the contract both sides
       of the differential rely on.
RT425  the differential over every rung of the ladder: the kernel must
       match its reference within the contract's tolerance.

The kernel side is the entry's wrapper: on a CPU tensor it runs its
plain version, so the probe there holds two independent torch
implementations against each other; on a CUDA tensor it launches the
CUDA kernel, and the probe holds the kernel itself.  Asked for the card
where there is none, each probe is a finding that names ``--device
cpu``: the plain versions never stand in for the kernels quietly.

Not ported: RT421, RT422 and RT424 check Pallas BlockSpec plans (block
divisibility, index maps, output aliases); the CUDA kernels' launch
geometry lives in ``csrc/*.cu``.
"""

from __future__ import annotations

import dataclasses
import functools

from repic_tpu_torch.analysis.engine import Finding

# rule id -> (severity, title, fix hint)
KERNEL_RULES = {
    "RT423": (
        "error",
        "kernel output structure differs from its reference's",
        "make the wrapper return the reference's tree: the same "
        "arity, shapes and dtypes (the differential compares leaf by "
        "leaf)",
    ),
    "RT425": (
        "error",
        "kernel diverges from its reference on a ladder rung",
        "fix the kernel (or its plain version on the CPU) until it "
        "matches the contract's reference within tol on every rung; "
        "the rung and the first differing leaf are in the message",
    ),
}


@dataclasses.dataclass(frozen=True)
class KernelContract:
    """What KERNELCHECK verifies about one kernel entry.

    Args:
        ladder: dims dicts to probe -- the capacity-bucket shapes the
            chunk path pads to, plus at least one ragged rung.
        make_inputs: ``dims -> (args tuple, kwargs dict)`` of CPU
            tensors (seeded), moved to the probe's device.
        reference: the unfused path with the entry's signature, the
            ground truth.
        run: the kernel side; default the entry's function with the
            contract's ``static`` keywords.
        compare: ``(got, want, tol) -> list[str]`` over host (numpy)
            outputs; default allclose over the flattened outputs.
        tol: absolute tolerance of the comparator.
    """

    ladder: tuple
    make_inputs: object
    reference: object
    run: object = None
    compare: object = None
    tol: float = 1e-6


def _kernel_callable(entry, kc):
    if kc.run is not None:
        return kc.run
    return functools.partial(entry.fn, **entry.contract.static)


def flatten(tree):
    """The leaves of nested tuples, lists and dicts (dicts by key)."""
    if isinstance(tree, (tuple, list)):
        out = []
        for t in tree:
            out.extend(flatten(t))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k]))
        return out
    return [tree]


def to_device(tree, device):
    """Tensors and modules of nested tuples, lists and dicts moved to
    ``device``, structure kept."""
    import torch

    if isinstance(tree, (torch.Tensor, torch.nn.Module)):
        return tree.to(device)
    if isinstance(tree, tuple):
        return tuple(to_device(t, device) for t in tree)
    if isinstance(tree, list):
        return [to_device(t, device) for t in tree]
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def _to_host(tree):
    """Tensors (on any device) as numpy arrays, structure kept."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple):
        return tuple(_to_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def _default_compare(got, want, tol) -> list[str]:
    import numpy as np

    gl, wl = flatten(got), flatten(want)
    if len(gl) != len(wl):
        return [
            f"output arity mismatch: kernel returned {len(gl)} "
            f"leaves, reference {len(wl)}"
        ]
    msgs = []
    for i, (g, w) in enumerate(zip(gl, wl)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            msgs.append(
                f"leaf {i}: kernel ({g.shape}, {g.dtype}) vs "
                f"reference ({w.shape}, {w.dtype})"
            )
            continue
        if not np.allclose(g, w, atol=tol, rtol=0.0):
            delta = float(np.max(np.abs(
                g.astype("float64") - w.astype("float64"))))
            msgs.append(
                f"leaf {i}: max |kernel - reference| = {delta:.3g} "
                f"> tol {tol:g}"
            )
    return msgs


def differential_probe(entry, kc, dims=None, device="cpu") -> list[str]:
    """Run kernel vs reference on one rung's inputs on ``device``.

    Returns divergence messages ([] when they agree).  Raises whatever
    the input maker, the kernel or the reference raises -- callers own the
    error discipline (KERNELCHECK records it as a violation)."""
    rung = dims if dims is not None else kc.ladder[0]
    args, kwargs = to_device(kc.make_inputs(dict(rung)), device)
    got = _to_host(_kernel_callable(entry, kc)(*args, **kwargs))
    want = _to_host(kc.reference(*args, **kwargs))
    cmp = kc.compare if kc.compare is not None else _default_compare
    return cmp(got, want, kc.tol)


def _finding(rule, path, line, message) -> Finding:
    severity, _title, hint = KERNEL_RULES[rule]
    return Finding(rule=rule, severity=severity, message=message,
                   hint=hint, path=path, line=line, col=0)


def _structure(tree) -> list:
    return [(tuple(getattr(t, "shape", ())), str(getattr(t, "dtype", "?"))
             .replace("torch.", "")) for t in flatten(tree)]


def probe_structure(entry, kc, device="cpu") -> list[str]:
    """RT423: kernel vs reference output trees on the ladder's first
    rung on ``device``; returns the mismatch ([] when they agree)."""
    rung = kc.ladder[0]
    args, kwargs = to_device(kc.make_inputs(dict(rung)), device)
    got = _structure(_kernel_callable(entry, kc)(*args, **kwargs))
    want = _structure(kc.reference(*args, **kwargs))
    if got == want:
        return []
    return [f"kernel output structure {got} does not match the "
            f"reference {want} (dims {dict(rung)})"]


def run_kernel_checks(entry, path, findings, want, device="cpu") -> None:
    """RT423 and RT425 for one ``@checked`` entry with a
    ``Contract.kernel``, on ``device``.  A probe that raises (a build
    or launch failure included) is a finding, and so is a card asked
    for where there is none."""
    import torch

    kc = entry.contract.kernel
    line = entry.lineno
    rules = [r for r in ("RT423", "RT425") if want(r)]
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        for rule in rules:
            findings.append(_finding(
                rule, path, line,
                f"{entry.name}(): device {device!r} requested but "
                "torch.cuda.is_available() is False: the kernel probe "
                "did not run (pass --device cpu to hold the plain "
                "version against the reference)"))
        return
    if "RT423" in rules:
        try:
            for msg in probe_structure(entry, kc, device):
                findings.append(_finding(
                    "RT423", path, line, f"{entry.name}(): {msg}"))
        except Exception as e:
            findings.append(_finding(
                "RT423", path, line,
                f"{entry.name}(): kernel probe failed on {device} -- "
                f"{type(e).__name__}: {e}"))
    if "RT425" not in rules:
        return
    for rung in kc.ladder:
        try:
            msgs = differential_probe(entry, kc, rung, device=device)
        except Exception as e:
            msgs = [f"probe failed -- {type(e).__name__}: {e}"]
        for msg in msgs:
            findings.append(_finding(
                "RT425", path, line,
                f"{entry.name}() on rung {dict(rung)}: the kernel "
                f"diverges from its reference on {device} -- {msg}"))
