"""The port's per-file rule pack (the port of
``repic_tpu.analysis.rules``): RT004 and the RT2xx project contracts.

Each rule targets a failure mode that is *silent* on the card: the
program stays correct but quietly serializes host and device, or
corrupts what ``--resume`` trusts.  Rules are dataflow-LOCAL: they
reason about one module at a time with no ``torch`` import and no type
inference, so a clean verdict is cheap and a finding is actionable at
the reported line.  The suppression escape hatch (``# repic:
noqa[RTxxx]``) documents the residual cases.

RT004  host sync on a launch's output or a CUDA tensor inside a hot
       loop (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
       ``float()/int()/bool()``, ``torch.cuda.synchronize()``)

Project-contract rules (``repic_tpu_torch/`` package files only):

RT201  file writes outside runtime/atomic.py must be atomic
RT202  span() under `with`; start_run paired with finally:finish_run
RT203  journal.record() statuses drawn from runtime/journal.py's enum
RT204  no bare print in library code (CLI command modules exempt)

The reference's RT001, RT002, RT003, RT005 and RT006 (jit static
arguments, tracer concretization, PRNG key reuse, jit recompiles,
``in_axes``/donation arity) have no subject in the port: it has no
jit, no traced values and no functional keys
(:data:`~repic_tpu_torch.analysis.engine.NOT_PORTED`).  The contract
rules RT101/RT102 live in :mod:`repic_tpu_torch.analysis.semantic`
(``check``): they import torch and the target modules.
"""

from __future__ import annotations

import ast
import functools
import os
import re

from repic_tpu_torch.analysis.engine import (
    CUDA_SYNC,
    Finding,
    ModuleContext,
    Rule,
    function_owner_map as _function_owner_map,
)

#: device->host fetches through numpy (``np.asarray(t)`` reads a CUDA
#: tensor back through ``__array__``)
_HOST_FETCHES = {"numpy.asarray", "numpy.array"}


def _walk_skip_functions(node):
    """ast.walk that does not descend into nested function bodies."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


class RT004HotLoopSync(Rule):
    """Unconditional host sync on a device value in a loop.

    ``.item()`` / ``.cpu()`` / ``np.asarray`` / ``float()`` on a
    launch's output or a CUDA tensor, and ``torch.cuda.synchronize()``,
    block the host until the card drains its queue: inside a loop that
    sync runs EVERY iteration, and the launches stop overlapping the
    host's work.  Syncs guarded by an ``if`` inside the loop (periodic
    logging) are accepted.
    """

    rule_id = "RT004"
    severity = "warning"
    title = "don't sync on device values every loop iteration"
    hint = (
        "accumulate on the device and fetch once after the loop, or "
        "guard the fetch with a periodic `if` (e.g. every N steps)"
    )

    _SYNC_BUILTINS = {"print", "float", "int", "bool"}
    _SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

    def check(self, ctx: ModuleContext) -> list[Finding]:
        findings: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.For, ast.While)):
                self._check_loop(ctx, node, findings)
        return findings

    def _check_loop(self, ctx, loop, findings):
        hot: set[str] = set()
        for n in _walk_skip_functions(loop):
            if isinstance(n, ast.Assign) and ctx.is_device_value_source(
                n.value
            ):
                for t in n.targets:
                    for name in ast.walk(t):
                        if isinstance(name, ast.Name):
                            hot.add(name.id)
        if not hot and not any(
            ctx.is_launch_call(n) for n in _walk_skip_functions(loop)
        ):
            return
        # the loop's own test/iter runs every iteration too: a
        # `while float(loss(x)) > eps:` is the headline hazard
        head = loop.test if isinstance(loop, ast.While) else loop.iter
        self._scan_expr(ctx, head, hot, findings)
        self._scan_unguarded(ctx, loop.body, hot, findings)

    def _mentions_hot(self, ctx, node, hot) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id in hot:
                return True
            if ctx.is_device_value_source(n):
                return True
        return False

    def _scan_unguarded(self, ctx, body, hot, findings):
        """Descend only through blocks that run every iteration.

        ``if`` blocks inside the loop are treated as intentional
        periodic guards (the standard log-every-N idiom) and skipped;
        nested loops, ``with`` and ``try`` bodies still run each
        iteration, so they are descended.
        """
        for stmt in body:
            if isinstance(
                stmt,
                (ast.If, ast.FunctionDef, ast.AsyncFunctionDef),
            ):
                continue  # guarded or deferred: not per-iteration
            if isinstance(stmt, (ast.For, ast.While)):
                expr = stmt.iter if isinstance(stmt, ast.For) else stmt.test
                self._scan_expr(ctx, expr, hot, findings)
                self._scan_unguarded(ctx, stmt.body, hot, findings)
                self._scan_unguarded(ctx, stmt.orelse, hot, findings)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    self._scan_expr(
                        ctx, item.context_expr, hot, findings
                    )
                self._scan_unguarded(ctx, stmt.body, hot, findings)
            elif isinstance(stmt, ast.Try):
                for blk in (
                    stmt.body, stmt.orelse, stmt.finalbody,
                    *(h.body for h in stmt.handlers),
                ):
                    self._scan_unguarded(ctx, blk, hot, findings)
            else:
                self._scan_expr(ctx, stmt, hot, findings)

    def _scan_expr(self, ctx, node, hot, findings):
        for n in _walk_skip_functions(node):
            if isinstance(n, ast.Call):
                self._check_call(ctx, n, hot, findings)
        if isinstance(node, ast.Call):
            self._check_call(ctx, node, hot, findings)

    def _check_call(self, ctx, call, hot, findings):
        func = call.func
        # x.item() / x.cpu() on a device value
        if (
            isinstance(func, ast.Attribute)
            and func.attr in self._SYNC_METHODS
            and self._mentions_hot(ctx, func.value, hot)
        ):
            findings.append(
                self.finding(
                    ctx,
                    call,
                    f".{func.attr}() on a device value inside a loop "
                    "syncs host and card every iteration",
                )
            )
            return
        target = ctx.imports.resolve(func)
        if target == CUDA_SYNC:
            findings.append(
                self.finding(
                    ctx,
                    call,
                    "torch.cuda.synchronize() inside a loop that "
                    "launches drains the card every iteration",
                )
            )
            return
        if target in _HOST_FETCHES and call.args:
            if self._mentions_hot(ctx, call.args[0], hot):
                findings.append(
                    self.finding(
                        ctx,
                        call,
                        f"{target}() on a device value inside a loop "
                        "syncs host and card every iteration",
                    )
                )
            return
        if (
            isinstance(func, ast.Name)
            and func.id in self._SYNC_BUILTINS
            and any(
                self._mentions_hot(ctx, a, hot)
                for a in list(call.args)
                + [k.value for k in call.keywords]
            )
        ):
            findings.append(
                self.finding(
                    ctx,
                    call,
                    f"{func.id}() touching a device value inside a "
                    "loop syncs host and card every iteration",
                )
            )


# -- RT2xx: project-contract rules ------------------------------------
#
# These enforce the port's runtime invariants: atomic artifact writes
# (runtime/atomic.py), balanced telemetry run scopes
# (telemetry/__init__.py), the journal outcome enum
# (runtime/journal.py), and structured logging (telemetry/events.py).
# They apply only to files inside the repic_tpu_torch package: bench
# scripts, chip_smoke.py and the reference package are not in scope.

PACKAGE = "repic_tpu_torch"


def _in_project(ctx: ModuleContext) -> bool:
    return PACKAGE in re.split(r"[\\/]", ctx.path)


def _basename(ctx: ModuleContext) -> str:
    return ctx.path.replace("\\", "/").rsplit("/", 1)[-1]


def _in_runtime_atomic(ctx: ModuleContext) -> bool:
    parts = re.split(r"[\\/]", ctx.path)
    return parts[-1] == "atomic.py" and (
        len(parts) < 2 or parts[-2] in ("runtime", PACKAGE))


def _is_cli_module(ctx: ModuleContext) -> bool:
    """The port's subcommand protocol: a top-level ``add_arguments``
    and ``main`` (``repic_tpu_torch/main.py`` dispatches them), or the
    reference's ``name = "..."`` plus ``main``; such a module's stdout
    IS its product surface."""
    top = {n.name for n in ctx.tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    has_name = any(
        isinstance(n, ast.Assign)
        and len(n.targets) == 1
        and isinstance(n.targets[0], ast.Name)
        and n.targets[0].id == "name"
        and isinstance(n.value, ast.Constant)
        and isinstance(n.value.value, str)
        for n in ctx.tree.body
    )
    return "main" in top and (has_name or "add_arguments" in top)


class RT201AtomicWrite(Rule):
    """File writes must route through the atomic-write helpers.

    A plain ``open(path, "w")`` that crashes mid-write leaves a torn
    file the resume machinery then trusts.  Every artifact writer goes
    through ``runtime.atomic.atomic_write`` or the tmp + ``os.replace``
    idiom; append-mode streams (journals, event logs) are exempt: a
    torn trailing line is handled by their readers.
    """

    rule_id = "RT201"
    severity = "error"
    title = "file writes go through atomic helpers (project)"
    hint = (
        "use repic_tpu_torch.runtime.atomic.atomic_write(path[, 'wb']),"
        " or write to a sibling temp file and os.replace() it into place"
    )

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not _in_project(ctx) or _in_runtime_atomic(ctx):
            return []
        owner = _function_owner_map(ctx.tree)
        # functions (and the module scope) that call os.replace are
        # hand-rolled atomic writers: their temp-file opens are fine
        replacers = set()
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and ctx.imports.resolve(node.func) == "os.replace"
            ):
                fn = owner.get(id(node))
                replacers.add(id(fn) if fn is not None else None)
        findings = []
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and ctx.imports.resolve(node.func) in ("open", "io.open")
            ):
                continue
            mode = next(
                (k.value for k in node.keywords if k.arg == "mode"),
                node.args[1] if len(node.args) > 1 else None,
            )
            if not (
                isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
            ):
                continue  # no/dynamic mode: default "r" or unknowable
            m = mode.value
            if not ("w" in m or "x" in m) or "a" in m:
                continue
            fn = owner.get(id(node))
            if (id(fn) if fn is not None else None) in replacers:
                continue
            findings.append(
                self.finding(
                    ctx,
                    node,
                    f"open(..., {m!r}) writes non-atomically; an "
                    "interrupted run leaves a torn artifact the "
                    "journal/resume machinery will trust",
                )
            )
        return findings


class RT202SpanBalance(Rule):
    """Telemetry scopes must be balanced by construction.

    ``span()`` keeps a contextvar stack and observes its duration at
    ``__exit__``: called without a ``with`` it leaks the span (the
    stack never pops, every later span mis-parents, the histogram never
    observes).  ``telemetry.start_run`` installs a process-wide event
    log; without ``finish_run`` in a ``finally`` an exception leaves
    the log installed and the metric sinks unwritten.
    """

    rule_id = "RT202"
    severity = "error"
    title = "span() needs `with`; start_run() needs finally:finish_run"
    hint = (
        "write `with span(...):` (never bare), and pair "
        "`rt = telemetry.start_run(...)` with "
        "`finally: telemetry.finish_run(rt)` in the same function"
    )

    _SPAN = {
        f"{PACKAGE}.telemetry.span",
        f"{PACKAGE}.telemetry.events.span",
    }
    _START = {f"{PACKAGE}.telemetry.start_run"}

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not _in_project(ctx):
            return []
        findings = []
        with_exprs = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    with_exprs.add(id(item.context_expr))
        owner = _function_owner_map(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.imports.resolve(node.func)
            if target in self._SPAN and id(node) not in with_exprs:
                findings.append(
                    self.finding(
                        ctx,
                        node,
                        "span() outside a `with` statement never "
                        "exits: the span stack leaks and the "
                        "duration histogram never observes",
                    )
                )
            elif target in self._START:
                fn = owner.get(id(node))
                scope = fn if fn is not None else ctx.tree
                if not self._has_finally_finish(ctx, scope):
                    findings.append(
                        self.finding(
                            ctx,
                            node,
                            "start_run() without a `finally: "
                            "finish_run(...)` in the same function "
                            "leaves the run log installed when the "
                            "run raises",
                        )
                    )
        return findings

    def _has_finally_finish(self, ctx, scope) -> bool:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Try):
                continue
            for stmt in node.finalbody:
                for call in ast.walk(stmt):
                    if isinstance(call, ast.Call):
                        t = ctx.imports.resolve(call.func) or ""
                        if t.endswith("finish_run"):
                            return True
        return False


@functools.lru_cache(maxsize=1)
def journal_statuses() -> frozenset:
    """The outcome enum: every module-level ``STATUS_* = "..."`` of the
    port's ``runtime/journal.py``, read from its source (the linter
    imports nothing it lints)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "runtime", "journal.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    out = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("STATUS_")
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            out.add(node.value.value)
    return frozenset(out)


class RT203JournalStatus(Rule):
    """Journal outcomes must come from the allowed enum.

    ``--resume`` decides what to re-process from the latest status
    string per micrograph (runtime/journal.py ``DONE_STATUSES``); a
    typo'd status ("retry", "OK") is silently treated as not-done and
    the micrograph re-processes forever.
    """

    rule_id = "RT203"
    severity = "error"
    title = "journal.record() status must be a known outcome"
    hint = (
        "use one of the STATUS_* constants of "
        "repic_tpu_torch.runtime.journal (ok/retried/degraded/"
        "quarantined/skipped); resume semantics key on these exact "
        "strings"
    )

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not _in_project(ctx):
            return []
        allowed = journal_statuses()
        findings = []
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "record"
                and len(node.args) >= 2
            ):
                continue
            status = node.args[1]
            if (
                isinstance(status, ast.Constant)
                and isinstance(status.value, str)
                and status.value not in allowed
            ):
                findings.append(
                    self.finding(
                        ctx,
                        status,
                        f"journal status {status.value!r} is not one "
                        f"of {'/'.join(sorted(allowed))} -- resume "
                        "will re-process this entry forever",
                    )
                )
        return findings


class RT204NoBarePrint(Rule):
    """Library code must log through the structured logger.

    A bare ``print`` bypasses the run log (the record never reaches
    ``_events.jsonl``), ignores ``REPIC_TPU_LOG_LEVEL``, and inside the
    pipeline interleaves with real CLI output.  CLI command modules
    (``add_arguments`` + ``main``) are exempt: their stdout IS the
    product.  ``print(..., file=...)`` is exempt too: an explicit
    stream choice is how the structured logger itself emits.
    """

    rule_id = "RT204"
    severity = "error"
    title = "no bare print in library code (project)"
    hint = (
        "use repic_tpu_torch.telemetry.events.get_logger(name).info("
        "...): same text on stdout, plus a structured record in the "
        "run log"
    )

    def check(self, ctx: ModuleContext) -> list[Finding]:
        if not _in_project(ctx) or _is_cli_module(ctx):
            return []
        findings = []
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.Call)
                and ctx.imports.resolve(node.func) == "print"
            ):
                continue
            if any(k.arg == "file" for k in node.keywords):
                continue
            findings.append(
                self.finding(
                    ctx,
                    node,
                    "bare print() in library code bypasses the "
                    "structured run log and REPIC_TPU_LOG_LEVEL",
                )
            )
        return findings


ALL_RULES = (
    RT004HotLoopSync,
    RT201AtomicWrite,
    RT202SpanBalance,
    RT203JournalStatus,
    RT204NoBarePrint,
)

RULES_BY_ID = {r.rule_id: r for r in ALL_RULES}
