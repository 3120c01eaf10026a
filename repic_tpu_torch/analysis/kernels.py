"""Kernel contracts: the differential half of the reference's RT42x
pack (the port of ``repic_tpu.analysis.kernels``).

A hand-written kernel declares, beside its entry's
:class:`~repic_tpu_torch.analysis.contracts.Contract`, a
:class:`KernelContract`: the shape ladder the chunk path pads to, a
function making concrete probe inputs, the unfused path it replaced
(the reference), a comparator and a tolerance.
:func:`differential_probe` runs kernel and reference on one rung's
inputs on a named device and returns the disagreements; KERNELCHECK
(:mod:`repic_tpu_torch.analysis.kernelcheck`) runs it over every rung
of every registered kernel.

The kernel side is the entry's wrapper: on a CPU tensor it runs its
plain version, so the probe there holds two independent torch
implementations against each other; on a CUDA tensor it launches the
CUDA kernel, and the probe holds the kernel itself.  The reference's
static half -- tiling plans, BlockSpec divisibility, index maps, the
VMEM estimate -- describes Pallas and belongs to ROADMAP Queue 1 item
9b.
"""

from __future__ import annotations

import dataclasses
import functools


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


def _flatten(tree):
    """The leaves of nested tuples, lists and dicts (dicts by key)."""
    if isinstance(tree, (tuple, list)):
        out = []
        for t in tree:
            out.extend(_flatten(t))
        return out
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k]))
        return out
    return [tree]


def _to_device(tree, device):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return tuple(_to_device(t, device) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
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

    gl, wl = _flatten(got), _flatten(want)
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
    args, kwargs = _to_device(kc.make_inputs(dict(rung)), device)
    got = _to_host(_kernel_callable(entry, kc)(*args, **kwargs))
    want = _to_host(kc.reference(*args, **kwargs))
    cmp = kc.compare if kc.compare is not None else _default_compare
    return cmp(got, want, kc.tol)
