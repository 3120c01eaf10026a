"""Rule engine of the port's static analyzer (the port of
``repic_tpu.analysis.engine``).

The engine owns everything rule-agnostic: file discovery, parsing,
per-module context construction (import-alias resolution, the registry
of launch sites), ``# repic: noqa[RTxxx]`` suppression, finding
collection and ordering, and report formatting.  Rules live in
:mod:`repic_tpu_torch.analysis.rules`; each is a small class with an
ID, severity, fix hint, and a ``check(ctx)`` method returning findings.

The reference's vocabulary is ``jax.jit``, ``jax.vmap`` and the PRNG;
the port's is the device launch: a function that binds a hand-written
kernel through :func:`repic_tpu_torch._build.load` (the kernels'
wrappers), a ``@checked`` entry point, and the host syncs a CUDA
tensor costs (``.item()``, ``.cpu()``, ``torch.cuda.synchronize()``).
Every rule is syntactic and local to one module and imports neither
``torch`` nor a module under analysis, so linting stays sub-second and
runs where there is no card.

The suppression syntax is the reference's, byte for byte: a
``# repic: noqa[RTxxx]`` carries across from one package to the other.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
import sys

# ``# repic: noqa`` (blanket) or ``# repic: noqa[RT001,RT003]``
_NOQA_RE = re.compile(
    r"#\s*repic:\s*noqa(?:\[(?P<ids>[A-Z0-9,\s]+)\])?", re.IGNORECASE
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str        # e.g. "RT004"
    severity: str    # "error" | "warning"
    message: str
    hint: str        # how to fix (rule-level, shown with --hints)
    path: str
    line: int        # 1-based
    col: int         # 0-based

    def format(self, show_hint: bool = False) -> str:
        s = (
            f"{self.path}:{self.line}:{self.col + 1}: "
            f"{self.rule} [{self.severity}] {self.message}"
        )
        if show_hint and self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ImportMap:
    """Local name -> canonical dotted path, from a module's imports.

    ``import torch.distributed as dist`` maps ``dist ->
    torch.distributed``; ``from functools import partial`` maps
    ``partial -> functools.partial``.  :meth:`resolve` canonicalizes a
    Name/Attribute chain (``dist.all_reduce`` ->
    ``torch.distributed.all_reduce``) so rules match semantics, not
    surface spelling.
    """

    def __init__(self, tree: ast.Module):
        self.names: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.names[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.names[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level:  # relative import: keep package-local
                    continue
                for a in node.names:
                    self.names[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )

    def resolve(self, node: ast.expr) -> str | None:
        """Canonical dotted path of a Name/Attribute chain, or None."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = self.names.get(node.id, node.id)
        parts.append(head)
        return ".".join(reversed(parts))


# -- the device-launch vocabulary --------------------------------------
#
# numpy may be imported as np/onp/numpy and torch.distributed as dist;
# canonicalization happens through ImportMap, so rules compare against
# these canonical names only.

PARTIAL = "functools.partial"
#: the kernel builder's loader: a function that calls it binds a
#: hand-written kernel and launches it, so it is a launch site
BUILD_LOAD = "repic_tpu_torch._build.load"
#: the entry-point contract decorator: a ``@checked`` entry is a launch
#: site too (it runs the device program of its contract)
CHECKED = "repic_tpu_torch.analysis.contracts.checked"
#: the kernels' wrappers, for callers in other modules (the per-file
#: engine sees only the module it lints)
LAUNCH_WRAPPERS = frozenset((
    "repic_tpu_torch.ops.iou_pallas.topk_neighbors",
    "repic_tpu_torch.ops.iou_pallas.pallas_topk_neighbors",
    "repic_tpu_torch.ops.megakernel.fused_clique_candidates",
    "repic_tpu_torch.ops.megakernel.fused_dual_solve",
    "repic_tpu_torch.ops.megakernel.dual_ascent",
))
#: blocks the host until every launch queued on the card has finished
CUDA_SYNC = "torch.cuda.synchronize"

#: the reference's rules with no subject in the port: ``lint --select``
#: or ``check --select`` of one exits non-zero with its reason
NOT_PORTED = {
    "RT001": "jit static_argnames: the port has no jax.jit",
    "RT002": "traced-value control flow: the port has no traced values",
    "RT003": "PRNG key reuse: the port has no functional PRNG keys",
    "RT005": "jit recompilation hazards: the port has no jax.jit",
    "RT006": "vmap in_axes / jit donate_argnums arity: the port has "
             "neither",
    "RT103": "buffer donation: the port's entries donate no buffers",
    "RT105": "jit recompile variants: the port compiles no traced "
             "programs",
    "RT403": "host syncs in PartitionSpec'd sharded jit entries: the "
             "port has no sharded jit entries",
    "RT421": "Pallas BlockSpec/grid divisibility: the CUDA kernels' "
             "launch geometry lives in csrc/*.cu",
    "RT422": "Pallas BlockSpec index maps: the CUDA kernels' launch "
             "geometry lives in csrc/*.cu",
    "RT424": "Pallas output aliasing: the CUDA kernels alias no "
             "buffers",
    "RT501": "chains of jitted programs: the port has no jax.jit",
    "RT503": "compile-shape minting: the port compiles no traced "
             "programs",
    "RT511": "static VMEM footprint: kernel 3's shared memory is sized "
             "and checked at run time (ops/megakernel.py)",
}


def unported_selection(select) -> str | None:
    """The usage error for a ``--select`` naming reference rules the
    port does not have, else None."""
    gone = sorted(set(select or ()) & set(NOT_PORTED))
    if not gone:
        return None
    return "; ".join(
        f"{r} is not ported ({NOT_PORTED[r]})" for r in gone
    )


def parse_select(text) -> set | None:
    """``"RT004, rt201"`` -> ``{"RT004", "RT201"}``; None when empty."""
    if not text:
        return None
    return {s.strip().upper() for s in text.split(",") if s.strip()}


def positional_params(fn) -> list:
    """Positional parameter names (posonly + regular) of a def/lambda."""
    a = fn.args
    return [p.arg for p in a.posonlyargs] + [p.arg for p in a.args]


def _is_checked_decorator(dec, imports: ImportMap) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    dotted = imports.resolve(target) or ""
    return dotted == CHECKED or dotted == "checked" or dotted.endswith(
        ".checked")


def is_build_load(dotted: str) -> bool:
    """A call of the kernel builder's loader, however imported."""
    return dotted == BUILD_LOAD or dotted.endswith("._build.load")


def _creates_cuda_tensor(call: ast.Call) -> bool:
    """``x.cuda()``, ``x.to("cuda")`` or any call with a literal
    ``device="cuda..."``: the result lives on the card."""
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "cuda":
        return True

    def cuda_literal(node) -> bool:
        return isinstance(node, ast.Constant) and isinstance(
            node.value, str) and node.value.startswith("cuda")

    if isinstance(func, ast.Attribute) and func.attr == "to" and any(
            cuda_literal(a) for a in call.args[:1]):
        return True
    return any(k.arg == "device" and cuda_literal(k.value)
               for k in call.keywords)


class ModuleContext:
    """Everything rules need about one parsed module.

    Name resolution is SCOPE-AWARE: simple assignments are recorded per
    enclosing function, and lookups walk the lexical scope chain
    outward, so an unrelated local in another function never shadows
    the name being resolved.
    """

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.imports = ImportMap(tree)
        # name -> first FunctionDef anywhere (rule fallback lookups)
        self.defs: dict[str, ast.FunctionDef] = {}
        # id(scope)|None -> {name: value node or FunctionDef}
        self._scope_names: dict = {None: {}}
        # id(scope_node) -> enclosing scope node (None = module)
        self._scope_parent: dict = {}
        # id(any node) -> innermost enclosing function scope node
        self._node_scope: dict = {}
        self._index(tree, None)
        # the registry of launch sites: defs of this module that bind
        # a kernel through _build.load, and the @checked entries
        self.launch_names: set[str] = set()
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if any(_is_checked_decorator(d, self.imports)
                   for d in node.decorator_list):
                self.launch_names.add(node.name)
                continue
            if any(isinstance(n, ast.Call) and is_build_load(
                    self.imports.resolve(n.func) or "")
                   for n in ast.walk(node)):
                self.launch_names.add(node.name)

    # -- scope indexing -----------------------------------------------

    def _index(self, node, scope):
        """One recursive pass filling the scope tables."""
        skip = set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # decorators were already indexed in the OUTER scope
            skip = {id(d) for d in node.decorator_list}
        for child in ast.iter_child_nodes(node):
            if id(child) in skip:
                continue
            self._node_scope[id(child)] = scope
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                self.defs.setdefault(child.name, child)
                self._scope_names.setdefault(
                    id(scope) if scope else None, {}
                )[child.name] = child
                self._scope_parent[id(child)] = scope
                self._scope_names.setdefault(id(child), {})
                # decorators/defaults evaluate in the OUTER scope
                for dec in child.decorator_list:
                    self._index_expr(dec, scope)
                self._index(child, child)
            else:
                if isinstance(child, ast.Assign) and len(
                    child.targets
                ) == 1 and isinstance(child.targets[0], ast.Name):
                    self._scope_names.setdefault(
                        id(scope) if scope else None, {}
                    )[child.targets[0].id] = child.value
                self._index(child, scope)

    def _index_expr(self, node, scope):
        self._node_scope[id(node)] = scope
        for child in ast.iter_child_nodes(node):
            self._index_expr(child, scope)

    def scope_of(self, node):
        """Innermost enclosing function scope of an indexed node."""
        return self._node_scope.get(id(node))

    def lookup(self, name: str, scope):
        """Resolve ``name`` along the lexical scope chain."""
        while True:
            key = id(scope) if scope is not None else None
            bound = self._scope_names.get(key, {})
            if name in bound:
                return bound[name]
            if scope is None:
                return None
            scope = self._scope_parent.get(id(scope))

    def resolve_callable(self, node, scope=None, _depth=0):
        """Chase ``node`` to a function definition.

        Returns ``(funcdef_or_lambda, bound_names)`` or ``(None,
        set())``.  Chases a Name bound (in the lexical scope chain) to
        a def or a simple assignment, and ``functools.partial(f,
        **kw)`` (the bound parameter names are returned).
        """
        if _depth > 6:
            return None, set()
        if scope is None:
            scope = self.scope_of(node)
        if isinstance(node, ast.Lambda):
            return node, set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node, set()
        if isinstance(node, ast.Name):
            value = self.lookup(node.id, scope)
            if value is None:
                value = self.defs.get(node.id)
            if value is None or value is node:
                return None, set()
            return self.resolve_callable(
                value, self.scope_of(value) or scope, _depth + 1
            )
        if isinstance(node, ast.Call) and node.args and (
                self.imports.resolve(node.func) == PARTIAL):
            fn, bound = self.resolve_callable(
                node.args[0], scope, _depth + 1
            )
            if fn is None:
                return None, set()
            bound = bound | {k.arg for k in node.keywords if k.arg}
            if isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                bound |= set(positional_params(fn)[: len(node.args) - 1])
            return fn, bound
        return None, set()

    # -- launch sites -------------------------------------------------

    def is_launch_call(self, node) -> bool:
        """A call of a launch site: a kernel wrapper or a ``@checked``
        entry of this module, or a known wrapper imported from
        another."""
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        if isinstance(func, ast.Name) and func.id in self.launch_names:
            return True
        return (self.imports.resolve(func) or "") in LAUNCH_WRAPPERS

    def is_device_value_source(self, node) -> bool:
        """A call whose result lives on the card: a launch, or a tensor
        made on (or moved to) ``cuda``."""
        return isinstance(node, ast.Call) and (
            self.is_launch_call(node) or _creates_cuda_tensor(node))


class Rule:
    """Base class: one rule = one ID + severity + hint + check()."""

    rule_id = "RT000"
    severity = "warning"
    title = ""
    hint = ""

    def check(self, ctx: ModuleContext) -> list[Finding]:
        raise NotImplementedError

    def finding(
        self, ctx: ModuleContext, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.rule_id,
            severity=self.severity,
            message=message,
            hint=self.hint,
            path=ctx.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
        )


def suppressed_ids(line: str) -> set | None:
    """IDs suppressed by a ``# repic: noqa`` comment on ``line``.

    Returns None when there is no noqa comment; an empty set means a
    blanket suppression (every rule).
    """
    m = _NOQA_RE.search(line)
    if not m:
        return None
    ids = m.group("ids")
    if ids is None:
        return set()
    return {s.strip().upper() for s in ids.split(",") if s.strip()}


def _line_suppresses(lines: list[str], lineno: int, rule: str) -> bool:
    idx = lineno - 1
    if not (0 <= idx < len(lines)):
        return False
    ids = suppressed_ids(lines[idx])
    if ids is None:
        return False
    return not ids or rule in ids


def _is_suppressed(finding: Finding, lines: list[str]) -> bool:
    return _line_suppresses(lines, finding.line, finding.rule)


def function_owner_map(tree) -> dict:
    """id(node) -> innermost enclosing function node (None=module).

    Shared by the RT2xx rules (os.replace / finally:finish_run scope
    checks)."""
    owner: dict = {}

    def visit(node, fn):
        for c in ast.iter_child_nodes(node):
            owner[id(c)] = fn
            nf = (
                c
                if isinstance(
                    c, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                else fn
            )
            visit(c, nf)

    visit(tree, None)
    return owner


def decorator_line_map(tree: ast.Module) -> dict:
    """def-lineno -> decorator line range, for decorated definitions.

    A ``# repic: noqa[RTxxx]`` on a decorator line must also suppress
    findings anchored to the decorated ``def`` line: the decorator
    (``@checked``) is usually what the finding is ABOUT, and pushing
    the comment onto the ``def`` line itself separates it from the
    construct it justifies.
    """
    out: dict[int, range] = {}
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ) and node.decorator_list:
            first = min(d.lineno for d in node.decorator_list)
            out[node.lineno] = range(first, node.lineno)
    return out


def call_span_map(tree: ast.Module) -> dict:
    """first-lineno -> continuation-line range, for multi-line calls.

    Findings anchor to a call's FIRST line (``node.lineno``), but the
    natural place for a ``# repic: noqa[RTxxx]`` on a multi-line call
    is the closing-paren line.  This map lets :func:`filter_suppressed`
    honor a noqa on ANY line of the call expression.
    """
    out: dict[int, range] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        end = getattr(node, "end_lineno", None)
        if end is None or end <= node.lineno:
            continue
        prev = out.get(node.lineno)
        stop = max(end + 1, prev.stop if prev is not None else 0)
        out[node.lineno] = range(node.lineno + 1, stop)
    return out


def filter_suppressed(
    findings,
    lines: list[str],
    dec_map: dict | None = None,
    span_map: dict | None = None,
) -> list:
    """Drop findings silenced by ``# repic: noqa`` comments: on the
    finding's own line, on the decorator lines above a decorated
    ``def`` it anchors to (:func:`decorator_line_map`), or on any
    continuation line of a multi-line call it anchors to
    (:func:`call_span_map`)."""
    out = []
    for f in findings:
        if _is_suppressed(f, lines):
            continue
        suppressed = False
        for m in (dec_map, span_map):
            rng = (m or {}).get(f.line)
            if rng is not None and any(
                _line_suppresses(lines, ln, f.rule) for ln in rng
            ):
                suppressed = True
                break
        if suppressed:
            continue
        out.append(f)
    return out


def analyze_source(
    source: str,
    path: str = "<string>",
    select: set | None = None,
    rules=None,
) -> list[Finding]:
    """Run the rule pack over one module's source text."""
    from repic_tpu_torch.analysis.rules import ALL_RULES

    rules = ALL_RULES if rules is None else rules
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                rule="RT000",
                severity="error",
                message=f"syntax error: {e.msg}",
                hint="",
                path=path,
                line=e.lineno or 1,
                col=(e.offset or 1) - 1,
            )
        ]
    ctx = ModuleContext(path, source, tree)
    findings: list[Finding] = []
    for rule_cls in rules:
        if select and rule_cls.rule_id not in select:
            continue
        findings.extend(rule_cls().check(ctx))
    findings = filter_suppressed(
        findings, ctx.lines, decorator_line_map(tree),
        call_span_map(tree),
    )
    # stable report order; dedupe identical (rule, line, col) repeats
    seen = set()
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule)):
        key = (f.rule, f.path, f.line, f.col)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def iter_python_files(paths, missing=None):
    """Yield .py files under ``paths`` (files or directories).

    A path that exists as neither is appended to ``missing`` (when
    given) instead of being silently skipped: a vacuous lint pass on a
    typo'd path must not read as a green gate.
    """
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        if not os.path.isdir(p):
            if missing is not None:
                missing.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(
                d
                for d in dirnames
                if not d.startswith(".") and d != "__pycache__"
            )
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.join(dirpath, fn)


def missing_path_finding(path: str) -> Finding:
    return Finding(rule="RT000", severity="error",
                   message="path does not exist", hint="", path=path,
                   line=1, col=0)


def run_paths(paths, select=None) -> list[Finding]:
    """Lint every Python file under ``paths``."""
    findings: list[Finding] = []
    missing: list[str] = []
    for path in iter_python_files(paths, missing=missing):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (OSError, UnicodeDecodeError) as e:
            findings.append(
                Finding(
                    rule="RT000",
                    severity="error",
                    message=f"cannot read file: {e}",
                    hint="",
                    path=path,
                    line=1,
                    col=0,
                )
            )
            continue
        findings.extend(analyze_source(source, path, select=select))
    findings.extend(missing_path_finding(p) for p in missing)
    return findings


def dedupe_findings(findings):
    """Sort by location and drop exact duplicates: merged passes each
    report a missing path as their own RT000, and one dedupe over the
    union keeps the report stable no matter which passes ran."""
    seen = set()
    out = []
    for f in sorted(
        findings, key=lambda f: (f.path, f.line, f.col, f.rule)
    ):
        key = (f.rule, f.path, f.line, f.col, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def format_report(
    findings,
    fmt: str = "text",
    show_hints: bool = False,
    statistics: bool = False,
    stream=None,
) -> int:
    """Print the report; return the process exit code (0 = clean)."""
    stream = stream or sys.stdout
    if fmt == "sarif":
        from repic_tpu_torch.analysis.sarif import render_sarif

        json.dump(render_sarif(findings), stream, indent=2)
        stream.write("\n")
    elif fmt == "json":
        json.dump([f.to_json() for f in findings], stream, indent=2)
        stream.write("\n")
    else:
        for f in findings:
            stream.write(f.format(show_hint=show_hints) + "\n")
        if statistics and findings:
            counts: dict[str, int] = {}
            for f in findings:
                counts[f.rule] = counts.get(f.rule, 0) + 1
            stream.write("--\n")
            for rule in sorted(counts):
                stream.write(f"{rule}: {counts[rule]}\n")
        if findings:
            n_err = sum(1 for f in findings if f.severity == "error")
            stream.write(
                f"found {len(findings)} issue(s) "
                f"({n_err} error(s), {len(findings) - n_err} warning(s))\n"
            )
    return 1 if findings else 0
