"""Whole-program device-cost and transfer-discipline analysis: RT5xx
(the port of ``repic_tpu.analysis.cost``, re-derived for the port's
launch sites).

A chunk of the port's consensus is a few kernel launches plus ONE
packed fetch, and every extra launch or host round trip on that path
costs more than the compute it moves.  This pass is the static gate
for that discipline.  Like RT3xx/RT40x it parses every module under
the given paths into one
:class:`~repic_tpu_torch.analysis.concurrency.Program` and reasons
over resolved call edges.  A *launch site* is a function that binds a
hand-written kernel through ``_build.load`` (the kernels' wrappers in
``ops/``); a call *reaches* one when its resolved callee launches
directly or through its own callees.

RT502  device->host fetch feeding a launch from inside a loop --
       ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
       ``np.asarray``, ``float()``/``int()``/``bool()`` on a device
       value -- whose result feeds back into a call that launches (or
       transitively reaches) a kernel.  Each iteration pays a full
       serialized round trip: the per-item ladder RT004 catches within
       one file, generalized interprocedurally.
RT512  declared dispatch budgets -- ``@checked`` entries may declare
       ``dispatch_budget=``; the rule counts the launch sites
       statically reachable along the entry's resolved call graph and
       fails when the count exceeds the declaration.  The dynamic half
       is the DISPATCHCHECK sanitizer
       (:mod:`repic_tpu_torch.analysis.dispatchcheck`), which asserts
       the same budgets against per-chunk launch counters.

Not ported: RT501 (chains of jitted programs) and RT503 (compile-shape
minting) have no subject without jit; RT511 (the static VMEM
footprint) is held at run time, where ``ops/megakernel.py`` sizes and
checks kernel 3's shared memory.

Like every static pass this imports no torch: pure ``ast`` over source
text.  Suppress with ``# repic: noqa[RT5xx]`` on the finding's line,
its decorator lines, or any continuation line of a multi-line call.
"""

from __future__ import annotations

import ast

from repic_tpu_torch.analysis.concurrency import (
    Program,
    _FnWalker,
    _mk,
    _suppressed,
    build_program,
)
from repic_tpu_torch.analysis.engine import (
    LAUNCH_WRAPPERS,
    Finding,
    Rule,
    dedupe_findings,
    is_build_load,
)
from repic_tpu_torch.analysis.spmd import (
    _calls_lexical,
    _closure_from,
    _stmts_walk,
)

# -- rule metadata ----------------------------------------------------


class RT502LoopFetchFeedback(Rule):
    rule_id = "RT502"
    severity = "warning"
    title = (
        "device->host fetch inside a loop feeds back into a kernel "
        "launch"
    )
    hint = (
        "batch the decision on the device (masks, torch.where) or "
        "hoist the fetch out of the loop: each iteration pays a "
        "serialized host<->card round trip; a deliberate "
        "escalate-and-retry loop is justified with "
        "# repic: noqa[RT502] and a comment"
    )


class RT512DispatchBudget(Rule):
    rule_id = "RT512"
    severity = "error"
    title = (
        "reachable kernel launch sites exceed the entry's declared "
        "dispatch_budget"
    )
    hint = (
        "fuse or gate the extra launches (one chunk should be a few "
        "launches plus one fetch in steady state), or raise "
        "dispatch_budget= with a comment explaining the extra "
        "launches; DISPATCHCHECK asserts the same budget at run time"
    )


COST_RULES = {
    r.rule_id: r
    for r in (
        RT502LoopFetchFeedback,
        RT512DispatchBudget,
    )
}

# -- canonical names --------------------------------------------------

#: fully-resolved device->host fetch calls
FETCH_CALLS = {
    "numpy.asarray": "np.asarray()",
    "numpy.array": "np.array()",
}

#: attribute tails that force a device->host transfer
FETCH_ATTR_TAILS = {"item", "tolist", "cpu", "numpy"}

#: builtin casts that are fetches ONLY when applied to device values
FETCH_CASTS = {"float", "int", "bool"}


# -- launch-site discovery --------------------------------------------


class _Ctx:
    """Program-wide launch facts shared by the RT5xx rules."""

    def __init__(self):
        self.launch_fn_ids: set[int] = set()        # id(FunctionInfo)
        self.dispatch_reach: dict[int, str] = {}    # fid -> witness
        self.budgeted: list[tuple] = []  # (fn, budget, kw node)
        self.checked_entries = 0


def _resolved(mod, node) -> str:
    return mod.imports.resolve(node) or ""


def _load_sites(fn) -> list:
    """``_build.load(...)`` calls in one function body: each binds a
    kernel the function then launches."""
    return [
        call for call in _calls_lexical(fn.node.body)
        if is_build_load(_resolved(fn.module, call.func))
    ]


def _build_ctx(program: Program, walkers) -> _Ctx:
    ctx = _Ctx()
    for fn in program.functions:
        if _load_sites(fn) or fn.qual in LAUNCH_WRAPPERS:
            ctx.launch_fn_ids.add(id(fn))
    _collect_contracts(program, ctx)
    ctx.dispatch_reach = _dispatch_reach(program, walkers, ctx)
    return ctx


def _device_call_kind(walker, call: ast.Call, ctx: _Ctx):
    """'launch' when the call runs a launch site, else None.
    Conservative: an unresolvable callee is never a launch."""
    if _resolved(walker.mod, call.func) in LAUNCH_WRAPPERS:
        return "launch"
    callee = walker.resolve_callee(call.func)
    if callee is not None and id(callee) in ctx.launch_fn_ids:
        return "launch"
    return None


def _dispatch_reach(program: Program, walkers, ctx: _Ctx) -> dict:
    """fid -> witness chain for every function that reaches a launch
    site through resolved callees (the RT40x fixed-point shape)."""
    reach: dict[int, str] = {}
    for fn in program.functions:
        if id(fn) in ctx.launch_fn_ids:
            reach[id(fn)] = fn.qual
    callers: dict[int, list] = {}
    for fn, callee, _node, _held in program.calls:
        callers.setdefault(id(fn), []).append((fn, callee))
    for _ in range(12):
        changed = False
        for fid, pairs in callers.items():
            if fid in reach:
                continue
            for fn, callee in pairs:
                got = reach.get(id(callee))
                if got is not None:
                    reach[fid] = f"{fn.qual} -> {got}"
                    changed = True
                    break
        if not changed:
            break
    return reach


# -- fetch detection --------------------------------------------------


def _fetch_desc(walker, call: ast.Call, device_names) -> str | None:
    """Reason string when ``call`` is a device->host fetch.  Builtin
    casts count only when their argument depends on a device value
    (``device_names``): ``float("0.5")`` is not a transfer."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr in FETCH_ATTR_TAILS:
        return f".{func.attr}()"
    dotted = _resolved(walker.mod, func)
    if dotted in FETCH_CALLS:
        return FETCH_CALLS[dotted]
    if isinstance(func, ast.Name) and func.id in FETCH_CASTS:
        for arg in call.args:
            for nm in ast.walk(arg):
                if isinstance(nm, ast.Name) and nm.id in device_names:
                    return f"{func.id}() on device value"
    return None


def _assign_parts(stmt):
    if isinstance(stmt, ast.Assign):
        return stmt.targets, stmt.value
    if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        return [stmt.target], stmt.value
    return None, None


def _target_names(targets):
    out = []
    for t in targets or ():
        for nm in ast.walk(t):
            if isinstance(nm, ast.Name):
                out.append(nm.id)
    return out


# -- RT502: loop fetch feedback ---------------------------------------


def _device_tainted_names(walker, ctx: _Ctx) -> set:
    """Names assigned from launch results (flow-insensitive)."""
    out: set[str] = set()
    for _ in range(2):
        for node in _stmts_walk(walker.fn.node.body):
            targets, value = _assign_parts(node)
            if value is None:
                continue
            hit = False
            for sub in ast.walk(value):
                if isinstance(sub, ast.Call) and _device_call_kind(
                    walker, sub, ctx
                ):
                    hit = True
                elif isinstance(sub, ast.Name) and sub.id in out:
                    hit = True
            if hit:
                out.update(_target_names(targets))
    return out


def _first_fetch_in(walker, expr, device_names, fetch_by_name):
    """``(desc, node)`` of the first fetch this expression depends
    on, via a direct fetch call or an already-fetch-tainted name."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            desc = _fetch_desc(walker, sub, device_names)
            if desc is not None:
                return desc, sub
        elif isinstance(sub, ast.Name) and sub.id in fetch_by_name:
            return fetch_by_name[sub.id]
    return None


def _callees(walker, func) -> list:
    """The resolved callee of a call, or -- for a local name bound to
    ``a if cond else b`` (the escalation loop's choice of program) --
    the resolved callees of both arms."""
    callee = walker.resolve_callee(func)
    if callee is not None:
        return [callee]
    if not isinstance(func, ast.Name):
        return []
    out = []
    for node in _stmts_walk(walker.fn.node.body):
        if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.IfExp) and any(
                isinstance(t, ast.Name) and t.id == func.id
                for t in node.targets):
            for arm in (node.value.body, node.value.orelse):
                c = walker.resolve_callee(arm)
                if c is not None:
                    out.append(c)
    return out


def _rt502(program: Program, walkers, ctx: _Ctx):
    findings = []
    for fn in program.functions:
        w = walkers[id(fn)]
        device_names = _device_tainted_names(w, ctx)
        loops = [
            n
            for n in _stmts_walk(fn.node.body)
            if isinstance(n, (ast.For, ast.While))
        ]
        flagged: set[int] = set()
        for loop in loops:
            fetch_by_name: dict[str, tuple] = {}
            for _ in range(2):
                for st in _stmts_walk(loop.body):
                    targets, value = _assign_parts(st)
                    if value is None:
                        continue
                    hit = _first_fetch_in(
                        w, value, device_names, fetch_by_name
                    )
                    if hit is None:
                        continue
                    for name in _target_names(targets):
                        fetch_by_name.setdefault(name, hit)
            if not fetch_by_name and not any(
                isinstance(s, ast.Call)
                and _fetch_desc(w, s, device_names)
                for s in _stmts_walk(loop.body)
            ):
                continue
            for call in _calls_lexical(loop.body):
                kind = _device_call_kind(w, call, ctx)
                chain = None
                if kind is None:
                    chain = next(
                        (ctx.dispatch_reach[id(c)]
                         for c in _callees(w, call.func)
                         if id(c) in ctx.dispatch_reach), None)
                    if chain is None:
                        continue
                for arg in list(call.args) + [
                    k.value for k in call.keywords
                ]:
                    hit = _first_fetch_in(
                        w, arg, device_names, fetch_by_name
                    )
                    if hit is None:
                        continue
                    desc, node = hit
                    if id(node) in flagged:
                        continue
                    flagged.add(id(node))
                    via = (
                        f"launching call (via {chain})"
                        if chain
                        else "kernel launch"
                    )
                    findings.append(
                        _mk(
                            RT502LoopFetchFeedback,
                            w.mod.path,
                            node,
                            f"{desc} inside a loop in {fn.qual} feeds "
                            f"back into a {via} at line "
                            f"{call.lineno}: every iteration pays a "
                            f"serialized host<->card round trip",
                        )
                    )
    return findings


# -- RT512: declared dispatch budgets ---------------------------------


def _is_checked(fn, dec) -> bool:
    if not isinstance(dec, ast.Call):
        return False
    dotted = _resolved(fn.module, dec.func)
    return dotted == "checked" or dotted.endswith(".checked")


def _collect_contracts(program: Program, ctx: _Ctx) -> None:
    """Find ``@checked(Contract(...))`` decorations and record their
    literal ``dispatch_budget=`` declarations on the ctx."""
    for fn in program.functions:
        for dec in getattr(fn.node, "decorator_list", ()):
            if not _is_checked(fn, dec):
                continue
            ctx.checked_entries += 1
            for arg in list(dec.args) + [
                k.value for k in dec.keywords
            ]:
                if not isinstance(arg, ast.Call):
                    continue
                for kw in arg.keywords:
                    if (
                        kw.arg == "dispatch_budget"
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, int)
                    ):
                        ctx.budgeted.append(
                            (fn, kw.value.value, kw.value)
                        )


def _rt512(program: Program, walkers, ctx: _Ctx):
    findings = []
    for fn, budget, _node in ctx.budgeted:
        closure = _closure_from(program, [fn])
        sites = []
        for reached, _chain in closure.values():
            sites.extend(
                (reached.qual, call.lineno)
                for call in _load_sites(reached))
        if len(sites) > budget:
            via = ", ".join(sorted({q for q, _ in sites})[:6])
            findings.append(
                _mk(
                    RT512DispatchBudget,
                    fn.module.path,
                    fn.node,
                    f"{fn.qual} declares dispatch_budget={budget} "
                    f"but its call graph statically reaches "
                    f"{len(sites)} kernel launch sites ({via})",
                )
            )
    return findings


# -- entry point ------------------------------------------------------


def _passes(paths, built=None):
    program, errors = built if built is not None else build_program(paths)
    walkers = {
        id(fn): _FnWalker(program, fn) for fn in program.functions
    }
    return program, errors, walkers, _build_ctx(program, walkers)


def run_cost(paths, select=None, built=None) -> list[Finding]:
    """Run the RT5xx whole-program pass; returns filtered findings.
    ``built``: as for
    :func:`~repic_tpu_torch.analysis.concurrency.run_concurrency`."""
    program, errors, walkers, ctx = _passes(paths, built)
    raw = (
        _rt502(program, walkers, ctx)
        + _rt512(program, walkers, ctx)
    )
    findings = list(errors)
    for f, extra_lines in raw:
        if select and f.rule not in select:
            continue
        mod = program.by_path.get(f.path)
        if mod is not None and _suppressed(mod, f, extra_lines):
            continue
        findings.append(f)
    if select:
        findings = [
            f
            for f in findings
            if f.rule in select or f.rule == "RT000"
        ]
    return dedupe_findings(findings)


def cost_summary(paths, built=None) -> dict:
    """Non-vacuity surface: what the pass actually SAW.  A tree where
    these counts drop to zero means the pass went blind (an import
    drifted, a decorator was renamed), not that the tree is clean."""
    program, _errors, _walkers, ctx = _passes(paths, built)
    return {
        "functions": len(program.functions),
        "launch_sites": sum(
            len(_load_sites(fn)) for fn in program.functions),
        "launch_functions": len(ctx.launch_fn_ids),
        "checked_entries": ctx.checked_entries,
        "budgeted_entries": len(ctx.budgeted),
        "dispatch_reaching": len(ctx.dispatch_reach),
    }
