"""The contract checker: ``python -m repic_tpu_torch check`` (rules
RT101/RT102; the port of ``repic_tpu.analysis.semantic``).

Where :mod:`repic_tpu_torch.analysis.rules` reasons about source text,
this pass runs the program: it imports the target modules, collects the
entry points registered through ``@checked``
(:mod:`repic_tpu_torch.analysis.contracts`), builds inputs of the
contract's shapes and dtypes, runs each entry and holds its outputs to
the declared ones.

* The first way is ``torch.device("meta")``: tensors with shapes and
  dtypes but no storage, so the entry runs without a FLOP or a card --
  the port's counterpart of the reference's ``jax.eval_shape``.
* Some entries read values on the way (``.item()``, boolean masks, a
  kernel's launch), which meta tensors cannot give.  Those run instead
  on concrete seeded inputs at the contract's dims, on ``device``
  (the card unless the caller asks for the CPU).  That is not a skip:
  each ``checked`` record of the report names the route its entry took
  and, for ``concrete``, why the meta route failed.

An entry whose contract declares a
:class:`~repic_tpu_torch.analysis.kernels.KernelContract` also gets the
kernel probes RT423/RT425 (:func:`~repic_tpu_torch.analysis.kernels.
run_kernel_checks`) on ``device``.

Rules:

RT101  declared shape/dtype contract violated
RT102  declared mesh axis unknown to the project mesh

Not ported: RT103 (donation; the port's entries donate no buffers) and
RT105 (recompile variants; the port compiles no traced programs).

Degraded modes are STRUCTURED, never tracebacks: a module that fails
to import, or a missing torch, is a ``skipped`` record with a reason.
A missing card where the card was asked for is a finding, never a
quiet run on the CPU.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import importlib
import importlib.util
import inspect
import os
import re
import sys

from repic_tpu_torch.analysis.engine import (
    Finding,
    call_span_map,
    decorator_line_map,
    filter_suppressed,
    iter_python_files,
    missing_path_finding,
)
from repic_tpu_torch.analysis.kernels import flatten, to_device

# rule id -> (severity, fix hint)
SEMANTIC_RULES = {
    "RT101": (
        "error",
        "make the entry's output match its declared Contract (or fix "
        "the contract); the declaration is what the mesh split, the "
        "capacity planning and the kernel probes trust",
    ),
    "RT102": (
        "error",
        "mesh axis names must come from the project mesh "
        "(parallel/mesh.py) or the contract's mesh_axes: an unknown "
        "axis splits nothing",
    ),
}

#: the seed of every concrete input ``check`` builds
SEED = 0


class _ContractError(Exception):
    """A contract that cannot be synthesized (unbound symbol, ...)."""


class _NoDevice(Exception):
    """The concrete route needs a device this process cannot reach."""


def _finding(rule, path, line, message, col=0) -> Finding:
    severity, hint = SEMANTIC_RULES[rule]
    return Finding(
        rule=rule,
        severity=severity,
        message=message,
        hint=hint,
        path=path,
        line=line,
        col=col,
    )


@dataclasses.dataclass
class CheckReport:
    """Outcome of one ``check`` invocation."""

    findings: list
    checked: list  # [{"entry", "path", "line", "route"[, "meta_error"]}]
    skipped: list  # [{"path" | "entry", "reason"}]
    device: str = "cuda"

    def to_json(self) -> dict:
        return {
            "device": self.device,
            "findings": [f.to_json() for f in self.findings],
            "checked": self.checked,
            "skipped": self.skipped,
        }


# -- module discovery / import ---------------------------------------


def _module_name_for(path: str) -> str | None:
    """Dotted module name for a file inside a package tree, walking
    ``__init__.py`` ancestors up to the package root; None for a
    standalone file."""
    path = os.path.abspath(path)
    d, base = os.path.split(path)
    if base == "__init__.py":
        parts: list[str] = []
    elif base.endswith(".py"):
        parts = [base[:-3]]
    else:
        return None
    saw_pkg = False
    while os.path.exists(os.path.join(d, "__init__.py")):
        saw_pkg = True
        d, name = os.path.split(d)
        parts.insert(0, name)
    return ".".join(parts) if saw_pkg and parts else None


def _import_file(path: str, skipped: list):
    """Import one target module; failures become structured skips."""
    name = _module_name_for(path)
    try:
        if name is not None:
            try:
                return importlib.import_module(name)
            except ImportError:
                pass  # package root not importable: load by path
        unique = "_repic_check_" + re.sub(
            r"\W", "_", os.path.abspath(path)
        )
        if unique in sys.modules:
            return sys.modules[unique]
        spec = importlib.util.spec_from_file_location(unique, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"no loader for {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[unique] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            sys.modules.pop(unique, None)
            raise
        return mod
    except KeyboardInterrupt:
        raise  # a cancelled check must not read as green
    except BaseException as e:
        # a broken module must not kill check -- this includes
        # SystemExit (a guard-less script calling sys.exit at import)
        skipped.append(
            {
                "path": path,
                "reason": f"import-error: {type(e).__name__}: {e}",
            }
        )
        return None


def _entry_path(entry) -> str | None:
    mod = sys.modules.get(entry.module)
    f = getattr(mod, "__file__", None)
    return os.path.realpath(f) if f else None


def _entry_params(entry) -> list:
    try:
        return list(inspect.signature(entry.fn).parameters)
    except (TypeError, ValueError):
        return []


# -- inputs -----------------------------------------------------------


def _torch_dtype(name: str):
    import torch

    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise _ContractError(f"unknown dtype {name!r}")
    return dt


def _resolve_shape(shape, dims) -> tuple:
    out = []
    for s in shape:
        if isinstance(s, str):
            if s not in dims:
                raise _ContractError(
                    f"shape symbol {s!r} is not bound in dims"
                )
            out.append(int(dims[s]))
        else:
            out.append(int(s))
    return tuple(out)


def _arg_shape(contract, sp) -> tuple:
    shape = _resolve_shape(sp.shape, contract.dims)
    if contract.batch is not None and shape:
        shape = (int(contract.batch),) + shape
    return shape


def _make_tensor(shape, dtype, device, generator):
    """Seeded values in ranges every entry accepts: floats in [0, 1),
    bools true three times in four, integers 0 or 1 (valid ids)."""
    import torch

    if device == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    if dtype == torch.bool:
        t = torch.rand(shape, generator=generator) < 0.75
    elif dtype.is_floating_point:
        t = torch.rand(shape, generator=generator).to(dtype)
    else:
        t = torch.randint(0, 2, shape, generator=generator, dtype=dtype)
    return t.to(device)


def _inputs(contract, device) -> tuple:
    """``(args, kwargs)`` on ``device`` (``"meta"`` for the shape-only
    route)."""
    import torch

    if contract.example is not None:
        return tuple(to_device(tuple(contract.example()), device)), {}
    if contract.args is None:
        raise _ContractError("contract declares neither args nor example")
    g = torch.Generator().manual_seed(SEED)
    kwargs = {}
    for name, sp in contract.args.items():
        if sp is None:
            raise _ContractError(f"arg {name!r} has no ArraySpec")
        kwargs[name] = _make_tensor(
            _arg_shape(contract, sp), _torch_dtype(sp.dtype), device, g)
    return (), kwargs


def _device_usable(device: str) -> None:
    import torch

    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise _NoDevice(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False (pass --device cpu to run on the CPU)")


# -- RT101: outputs against the declared contract ---------------------


def _dtype_name(t) -> str:
    return str(getattr(t, "dtype", "?")).replace("torch.", "")


def _leaf_mismatch(label, got, sp, contract, batched=True):
    """Compare one output leaf against one ArraySpec; message or None."""
    want_shape = _resolve_shape(sp.shape, contract.dims)
    if batched and contract.batch is not None:
        want_shape = (int(contract.batch),) + want_shape
    got_shape = tuple(getattr(got, "shape", ()))
    if got_shape != want_shape:
        return (
            f"output {label} has shape {got_shape}, contract "
            f"declares {want_shape}"
        )
    if sp.dtype is not None and _dtype_name(got) != sp.dtype:
        return (
            f"output {label} has dtype {_dtype_name(got)}, contract "
            f"declares {sp.dtype}"
        )
    return None


def _compare_returns(entry, out, inputs, findings):
    from repic_tpu_torch.analysis.contracts import ArraySpec

    contract = entry.contract
    ret = contract.returns
    path = _entry_path(entry) or entry.module
    if ret is None:
        return

    def emit(msg):
        findings.append(
            _finding(
                "RT101", path, entry.lineno,
                f"{entry.name}(): {msg}",
            )
        )

    if callable(ret) and not isinstance(ret, ArraySpec):
        # the expected tree of the inputs, shapes already concrete
        ret = ret(inputs)
        got_leaves = flatten(out)
        want_leaves = flatten(ret)
        if len(got_leaves) != len(want_leaves):
            emit(
                f"output has {len(got_leaves)} leaves, contract "
                f"expects {len(want_leaves)}"
            )
            return
        for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
            msg = _leaf_mismatch(f"leaf {i}", g, w, contract,
                                 batched=False)
            if msg:
                emit(msg)
        return
    if isinstance(ret, ArraySpec):
        msg = _leaf_mismatch("value", out, ret, contract)
        if msg:
            emit(msg)
        return
    if isinstance(ret, dict):
        got_map = (
            out._asdict() if hasattr(out, "_asdict") else dict(out)
        )
        for field, sp in ret.items():
            if sp is None:
                continue
            if field not in got_map:
                emit(f"output has no field {field!r}")
                continue
            msg = _leaf_mismatch(
                f"field {field!r}", got_map[field], sp, contract
            )
            if msg:
                emit(msg)
        return
    # positional sequence of specs (None entries unchecked)
    got_seq = list(out) if isinstance(out, (tuple, list)) else [out]
    if len(got_seq) != len(ret):
        emit(
            f"output has {len(got_seq)} entries, contract declares "
            f"{len(ret)}"
        )
        return
    for i, sp in enumerate(ret):
        if sp is None:
            continue
        msg = _leaf_mismatch(f"[{i}]", got_seq[i], sp, contract)
        if msg:
            emit(msg)


def _run(entry, device):
    args, kwargs = _inputs(entry.contract, device)
    fn = functools.partial(entry.fn, **entry.contract.static)
    return fn(*args, **kwargs), args + tuple(kwargs.values())


def _check_entry(entry, device, findings: list) -> dict:
    """RT101 for one entry; returns its ``checked`` record."""
    path = _entry_path(entry) or entry.module
    record = {"entry": entry.canonical, "path": path,
              "line": entry.lineno, "route": "meta"}

    def fail(msg):
        findings.append(_finding(
            "RT101", path, entry.lineno, f"{entry.name}(): {msg}"))
        return record

    try:
        out, inputs = _run(entry, "meta")
    except _ContractError as e:
        return fail(f"unusable contract -- {e}")
    except Exception as e:
        # the entry reads a value (or launches a kernel) on the way:
        # run it for real at the contract's dims
        record["route"] = "concrete"
        record["meta_error"] = f"{type(e).__name__}: {e}"[:300]
        try:
            _device_usable(device)
            out, inputs = _run(entry, device)
        except _NoDevice as e2:
            return fail(f"reads values, and {e2}")
        except Exception as e2:
            return fail(
                f"failed under the declared contract on {device} -- "
                f"{type(e2).__name__}: {e2}")
    _compare_returns(entry, out, inputs, findings)
    return record


# -- RT102: mesh axis names -------------------------------------------


def _project_mesh_axes() -> set:
    try:
        from repic_tpu_torch.parallel.mesh import mesh_axis_names

        return set(mesh_axis_names())
    except Exception:
        return set()


def _check_sharding(entry, findings: list) -> None:
    contract = entry.contract
    if not contract.pspecs:
        return
    path = _entry_path(entry) or entry.module
    known = _project_mesh_axes() | set(contract.mesh_axes)
    params = set(_entry_params(entry))
    for arg, axes in contract.pspecs.items():
        if params and arg not in params:
            findings.append(
                _finding(
                    "RT102", path, entry.lineno,
                    f"{entry.name}(): mesh axes declared for unknown "
                    f"parameter {arg!r}",
                )
            )
            continue
        for ax in axes:
            if ax is None:
                continue
            if ax not in known:
                findings.append(
                    _finding(
                        "RT102", path, entry.lineno,
                        f"{entry.name}(): mesh axis {ax!r} (parameter "
                        f"{arg!r}) is not a known mesh axis "
                        f"{sorted(known)}",
                    )
                )


# -- driver -----------------------------------------------------------


def run_check(paths, select=None, collect_only=False,
              device="cuda") -> CheckReport:
    """Run the contract checker over ``paths`` (files or directories).

    ``select`` restricts to a set of RT1xx/RT42x rule ids;
    ``collect_only`` imports and registers entries without checking
    (``--list-entries``); ``device`` is where the value-reading entries
    and the kernel probes run.
    """
    from repic_tpu_torch.analysis import contracts

    device = str(device)
    findings: list[Finding] = []
    skipped: list[dict] = []
    checked: list[dict] = []
    missing: list[str] = []
    files = [
        p
        for p in iter_python_files(paths, missing=missing)
        if os.path.basename(p) != "__main__.py"
    ]
    findings.extend(missing_path_finding(p) for p in missing)
    try:
        import torch  # noqa: F401
    except Exception as e:  # degraded: no torch in this environment
        skipped.extend(
            {
                "path": p,
                "reason": f"torch-unavailable: {type(e).__name__}: {e}",
            }
            for p in files
        )
        return CheckReport(findings, checked, skipped, device)

    for path in files:
        _import_file(path, skipped)

    file_set = {os.path.realpath(p) for p in files}
    entries = sorted(
        (
            e
            for e in contracts.registry().values()
            if _entry_path(e) in file_set
        ),
        key=lambda e: (e.module, e.lineno),
    )

    def want(rule):
        return select is None or rule in select

    for entry in entries:
        path = _entry_path(entry) or entry.module
        if collect_only or not want("RT101"):
            checked.append({"entry": entry.canonical, "path": path,
                            "line": entry.lineno, "route": "none"})
            continue
        checked.append(_check_entry(entry, device, findings))
    if collect_only:
        return CheckReport(findings, checked, skipped, device)

    for entry in entries:
        if want("RT102"):
            _check_sharding(entry, findings)
        if getattr(entry.contract, "kernel", None) is not None:
            from repic_tpu_torch.analysis.kernels import (
                KERNEL_RULES,
                run_kernel_checks,
            )

            if any(want(r) for r in KERNEL_RULES):
                run_kernel_checks(
                    entry,
                    _entry_path(entry) or entry.module,
                    findings,
                    want,
                    device=device,
                )

    # honor `# repic: noqa[RTxxx]` like the AST linter does
    by_path: dict[str, list] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    kept: list[Finding] = []
    for path, group in by_path.items():
        try:
            with open(path, encoding="utf-8") as fh:
                src = fh.read()
            tree = ast.parse(src, filename=path)
        except (OSError, SyntaxError, UnicodeDecodeError, ValueError):
            kept.extend(group)  # the AST linter owns reporting these
            continue
        kept.extend(
            filter_suppressed(
                group, src.splitlines(), decorator_line_map(tree),
                call_span_map(tree),
            )
        )
    seen = set()
    out = []
    for f in sorted(
        kept, key=lambda f: (f.path, f.line, f.col, f.rule)
    ):
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return CheckReport(out, checked, skipped, device)
