"""Entry-point contract registry: the ``@checked`` decorator (the port
of ``repic_tpu.analysis.contracts``).

Device entry points declare a :class:`Contract` -- synthetic input
shapes and dtypes, expected outputs, sharding axes, the per-chunk
dispatch budget, and for a hand-written kernel its
:class:`~repic_tpu_torch.analysis.kernels.KernelContract` -- through
``@checked``.  The runtime sanitizers read the registry:
KERNELCHECK (:mod:`~repic_tpu_torch.analysis.kernelcheck`) holds every
declared kernel against its unfused path, DISPATCHCHECK
(:mod:`~repic_tpu_torch.analysis.dispatchcheck`) holds each chunk's
launches and fetches to the budget of the entry it is attributed to.
The reference's trace-time checker of the shape half (``repic-tpu
check``) belongs to the static layer, ROADMAP Queue 1 item 9b.

Registration is import-time and FREE at call time: ``@checked``
records the function in a module-level registry and returns it
unchanged -- no wrapper, nothing on the hot path.  This module is
stdlib only, so any module may declare a contract.

Declaring a contract::

    from repic_tpu_torch.analysis.contracts import Contract, checked, spec

    @checked(Contract(
        args={"xy": spec("K N 2"), "mask": spec("K N", "bool")},
        returns=spec("N N"),
        dims={"K": 3, "N": 8},
    ))
    def my_kernel(xy, mask): ...
"""

from __future__ import annotations

import dataclasses
import inspect

# dtype spelling is the numpy/canonical name ("float32", "int32",
# "bool", "bfloat16").
DEFAULT_DTYPE = "float32"


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """One abstract array: shape of ints/symbols + dtype name."""

    shape: tuple
    dtype: str = DEFAULT_DTYPE


def spec(shape, dtype: str = DEFAULT_DTYPE) -> ArraySpec:
    """Build an :class:`ArraySpec` from ``"K N 2"`` / tuple shapes.

    String shapes are whitespace-split; integer-looking tokens become
    ints, everything else stays a symbol bound via ``Contract.dims``.
    ``spec("")`` is a scalar.
    """
    if isinstance(shape, str):
        toks = shape.split()
        shape = tuple(
            int(t) if t.lstrip("-").isdigit() else t for t in toks
        )
    return ArraySpec(shape=tuple(shape), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class Contract:
    """What one entry point declares about itself.

    Args:
        args: parameter name -> :class:`ArraySpec`, in signature
            order.  Mutually exclusive with ``example``.
        example: zero-arg callable returning the positional inputs --
            for entries that take parameter trees.
        returns: expected output -- an :class:`ArraySpec`, a sequence
            of specs (``None`` entries unchecked), a dict of field
            name -> spec, or a callable of the inputs.
        dims: symbol -> concrete size binding the specs' symbols.
        static: keyword arguments bound before a call (the entry's
            configuration knobs).
        pspecs: parameter name -> tuple of mesh axis names declaring
            how the batched form partitions that input
            (:data:`repic_tpu_torch.parallel.mesh.MICROGRAPH_AXIS`).
        mesh_axes: extra legal axis names beyond the project default.
        donate: parameter names whose buffers the entry may reuse.
        max_trace_variants: distinct static signatures the entry is
            expected to run under.
        kernel: optional
            :class:`repic_tpu_torch.analysis.kernels.KernelContract`
            for an entry that launches a hand-written kernel: its
            shape ladder, probe inputs, unfused reference, comparator
            and tolerance, which KERNELCHECK runs.  Typed ``object``
            so this module stays stdlib only.
        dispatch_budget: declared maximum kernel launches plus
            device-to-host fetches one accepted chunk attributed to
            this entry may cost; DISPATCHCHECK
            (``REPIC_TPU_DISPATCHCHECK=1``) asserts it per chunk.
            ``None`` opts out.
    """

    args: dict | None = None
    example: object = None
    returns: object = None
    dims: dict = dataclasses.field(default_factory=dict)
    static: dict = dataclasses.field(default_factory=dict)
    pspecs: dict = dataclasses.field(default_factory=dict)
    mesh_axes: tuple = ()
    donate: tuple = ()
    max_trace_variants: int = 4
    kernel: object = None
    dispatch_budget: int | None = None


@dataclasses.dataclass
class CheckedEntry:
    """One registered entry point (module-qualified)."""

    fn: object
    contract: Contract
    module: str
    qualname: str
    lineno: int

    @property
    def canonical(self) -> str:
        return f"{self.module}.{self.qualname}"

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


_REGISTRY: dict[str, CheckedEntry] = {}


def checked(contract: Contract):
    """Register ``fn`` (unchanged) under its module-qualified name."""

    def wrap(fn):
        inner = inspect.unwrap(
            fn, stop=lambda f: not hasattr(f, "__wrapped__")
        )
        code = getattr(inner, "__code__", None)
        entry = CheckedEntry(
            fn=fn,
            contract=contract,
            module=getattr(fn, "__module__", "?") or "?",
            qualname=getattr(
                fn, "__qualname__", getattr(fn, "__name__", "?")
            ),
            lineno=getattr(code, "co_firstlineno", 1),
        )
        _REGISTRY[entry.canonical] = entry
        return fn

    return wrap


def registry() -> dict[str, CheckedEntry]:
    """Snapshot of every entry registered so far (keyed by canonical
    dotted name)."""
    return dict(_REGISTRY)
