"""Whole-program SPMD-uniformity analysis: the RT40x rule pack (the
port of ``repic_tpu.analysis.spmd``, re-derived for
``torch.distributed``).

The port's gang (``parallel/gang.py``) runs one process per card, and
every process of an epoch must reach the same ``torch.distributed``
collectives and rendezvous points (the gloo group's MAX all-reduce of
the chunk's probes, ``init_process_group``, the barrier of a
teardown), in the SAME order.  Getting this wrong does not raise: one
rank that branched away from a collective wedges the others at it (the
watchdog then re-forms the gang), and a journal write outside the
epoch fence corrupts replay.

This pass is the static gate.  Like the RT3xx concurrency pass it
parses every module under the given paths into one
:class:`~repic_tpu_torch.analysis.concurrency.Program` and reasons
about reachability through the transitive callee fixed point:

RT401  rank-divergent control flow guarding a collective.  A branch
       condition that can differ per process --
       ``torch.distributed.get_rank()`` / ``runtime_identity()``,
       environment reads (``os.environ``/``os.getenv``), unsorted
       filesystem listings (``os.listdir``/``glob.glob`` without
       ``sorted()``), or data derived from ``shard_for_process()`` --
       makes the guarded region non-uniform.  If that region (or, when
       the divergent branch early-exits, the remainder of the
       function) reaches a collective or one of the port's gang
       dispatch points, the ranks that took the other path never
       arrive.  Only the GUARDED region matters: per-rank work
       (loading this rank's shard) behind a divergent guard stays
       clean.
RT402  collectives issued in different orders along sibling branches
       of one ``if``/``else``.  Order is inferred lexically and spliced
       through resolved callees (the fixed point RT302 uses for lock
       acquisition), so ``all_reduce(); helper()`` vs ``helper();
       all_reduce()`` is caught even when the second collective lives
       in another module.
RT404  non-epoch-tagged journal writes on gang execution paths: every
       ``record_event()`` issued from gang code (``parallel/gang.py``
       or anything it calls) must carry a ``gang_epoch=`` tag, or
       replay after a rank loss cannot tell pre-fence from post-fence
       events.

The reference's RT403 (host syncs reachable from PartitionSpec'd
sharded jit entries) has no subject here: the port has no sharded jit
entries.

Like every static pass this imports no torch: pure ``ast`` over source
text.  Resolution is conservative -- an unresolvable callee produces no
finding, never a guess.  Suppress with ``# repic: noqa[RT40x]`` on the
finding's line, its decorator lines, or any continuation line of a
multi-line call.
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
from repic_tpu_torch.analysis.engine import Finding, Rule, dedupe_findings

# -- rule metadata ----------------------------------------------------


class RT401DivergentCollective(Rule):
    rule_id = "RT401"
    severity = "error"
    title = (
        "rank-divergent control flow guards a path that reaches a "
        "collective"
    )
    hint = (
        "make the branch condition uniform across ranks (compute it "
        "from replicated data, or broadcast rank 0's decision before "
        "branching); if every rank provably takes the same path, "
        "justify with # repic: noqa[RT401] and a comment"
    )


class RT402CollectiveOrder(Rule):
    rule_id = "RT402"
    severity = "error"
    title = (
        "sibling branches issue collectives in different orders"
    )
    hint = (
        "hoist the common collectives out of the branch (or reorder "
        "one arm to match the other): if ranks ever disagree on the "
        "condition, mismatched collective order deadlocks the gang"
    )


class RT404UntaggedJournalWrite(Rule):
    rule_id = "RT404"
    severity = "error"
    title = (
        "journal record_event() on a gang path without gang_epoch="
    )
    hint = (
        "pass gang_epoch=<current epoch> so replay can fence the "
        "event (parallel/gang.py fencing contract); events from "
        "provably non-gang paths can be justified with "
        "# repic: noqa[RT404]"
    )


SPMD_RULES = {
    r.rule_id: r
    for r in (
        RT401DivergentCollective,
        RT402CollectiveOrder,
        RT404UntaggedJournalWrite,
    )
}

# -- canonical names --------------------------------------------------

#: fully-resolved calls that are (or dispatch) cross-process
#: collectives: ``torch.distributed``'s collectives and rendezvous
#: points, and the port's own gang dispatch points every rank must
#: reach together (the epoch's group, its MAX all-reduce, the global
#: batch's row layout)
COLLECTIVE_CALLS = {
    "torch.distributed.all_reduce": "all_reduce",
    "torch.distributed.all_gather": "all_gather",
    "torch.distributed.all_gather_object": "all_gather_object",
    "torch.distributed.all_to_all": "all_to_all",
    "torch.distributed.reduce_scatter": "reduce_scatter",
    "torch.distributed.broadcast": "broadcast",
    "torch.distributed.broadcast_object_list": "broadcast_object_list",
    "torch.distributed.barrier": "barrier",
    "torch.distributed.monitored_barrier": "monitored_barrier",
    "torch.distributed.init_process_group": "init_process_group",
    "torch.distributed.destroy_process_group": "destroy_process_group",
    "torch.distributed.new_group": "new_group",
    "repic_tpu_torch.parallel.distributed.init_gang_group": (
        "init_gang_group"
    ),
    "repic_tpu_torch.parallel.distributed.gang_all_reduce_max": (
        "gang_all_reduce_max"
    ),
    "repic_tpu_torch.parallel.distributed.assemble_global_batch": (
        "assemble_global_batch"
    ),
}

#: fully-resolved calls whose result can differ per process
DIVERGENT_CALLS = {
    "torch.distributed.get_rank": "torch.distributed.get_rank()",
    "os.getenv": "os.getenv()",
    "os.environ.get": "os.environ.get()",
    "socket.gethostname": "socket.gethostname()",
    "os.getpid": "os.getpid()",
    "os.uname": "os.uname()",
    "platform.node": "platform.node()",
}

#: attribute/name tails divergent regardless of how they were imported
DIVERGENT_TAILS = {
    "get_rank": "get_rank()",
    "runtime_identity": "runtime_identity()",
    "shard_for_process": "shard_for_process() result",
}

#: filesystem listings: order (and content) is host-local.  A direct
#: ``sorted(...)`` wrapper removes the ORDER nondeterminism, which is
#: the hazard this rule hunts.
LISTING_TAILS = {"listdir", "scandir", "iterdir", "glob", "iglob"}

_SEQ_CAP = 8  # collective-sequence length cap (fixed-point safety)


# -- shared walking helpers -------------------------------------------


def _walk_node_skip_nested(root):
    """Walk ``root`` (inclusive) without entering nested defs/lambdas."""
    stack = [root]
    first = True
    while stack:
        n = stack.pop()
        yield n
        dive = first or not isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)
        )
        first = False
        if dive:
            stack.extend(ast.iter_child_nodes(n))


def _stmts_walk(stmts):
    for s in stmts:
        if isinstance(
            s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        yield from _walk_node_skip_nested(s)


def _calls_lexical(stmts):
    """Every call under ``stmts`` (skipping nested defs), in source
    order."""
    out = [
        n for n in _stmts_walk(stmts) if isinstance(n, ast.Call)
    ]
    out.sort(key=lambda n: (n.lineno, n.col_offset))
    return out


def _collective_name(walker, call: ast.Call) -> str | None:
    return COLLECTIVE_CALLS.get(walker.mod.imports.resolve(call.func) or "")


# -- divergence sources (RT401) ---------------------------------------


def _divergence_in(walker, expr, tainted) -> str | None:
    """Reason string when ``expr`` depends on a rank-divergent
    source, else None.  ``tainted`` maps local names to the reason
    they are divergent."""
    if expr is None:
        return None
    stack = [(expr, False)]
    while stack:
        n, under_sorted = stack.pop()
        if isinstance(n, ast.Lambda):
            continue
        if isinstance(n, ast.Call):
            dotted = walker.mod.imports.resolve(n.func) or ""
            tail = dotted.rsplit(".", 1)[-1] if dotted else ""
            if isinstance(n.func, ast.Attribute):
                tail = n.func.attr
            if dotted in DIVERGENT_CALLS:
                return DIVERGENT_CALLS[dotted]
            if tail in DIVERGENT_TAILS:
                return DIVERGENT_TAILS[tail]
            if tail in LISTING_TAILS and not under_sorted:
                return f"unsorted {tail}()"
            if dotted == "sorted" or (
                isinstance(n.func, ast.Name) and n.func.id == "sorted"
            ):
                for c in ast.iter_child_nodes(n):
                    stack.append((c, True))
                continue
        elif isinstance(n, ast.Subscript):
            base = walker.mod.imports.resolve(n.value)
            if base == "os.environ":
                return "os.environ[...]"
        elif isinstance(n, ast.Name):
            if n.id in tainted:
                return tainted[n.id]
        for c in ast.iter_child_nodes(n):
            stack.append((c, under_sorted))
    return None


def _taint_map(walker) -> dict:
    """Local name -> divergence reason, from simple assignments.

    Two flow-insensitive passes so a taint assigned below its first
    guarded use still propagates (loop-carried bindings)."""
    tainted: dict[str, str] = {}
    fn_node = walker.fn.node
    for _ in range(2):
        for node in _stmts_walk(fn_node.body):
            if isinstance(node, ast.Assign):
                tgts, val = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                tgts, val = [node.target], node.value
            elif isinstance(node, ast.AugAssign):
                tgts, val = [node.target], node.value
            elif isinstance(node, ast.For):
                tgts, val = [node.target], node.iter
            elif isinstance(node, ast.NamedExpr):
                tgts, val = [node.target], node.value
            else:
                continue
            reason = _divergence_in(walker, val, tainted)
            if reason is None:
                continue
            for t in tgts:
                for nm in ast.walk(t):
                    if isinstance(nm, ast.Name):
                        tainted.setdefault(nm.id, reason)
    return tainted


# -- collective reachability (shared by RT401/RT402) ------------------


def _direct_collectives(walker) -> list:
    """Lexically ordered ``(name, lineno)`` direct collective calls."""
    out = []
    for call in _calls_lexical(walker.fn.node.body):
        name = _collective_name(walker, call)
        if name is not None:
            out.append((name, call.lineno))
    return out


def _collective_reach(program: Program, direct) -> dict:
    """fid -> (collective name, witness chain string): every function
    that reaches a collective, directly or through resolved callees
    (12-iteration fixed point, as in ``_transitive_acquires``)."""
    reach: dict[int, tuple] = {}
    for fn in program.functions:
        ds = direct.get(id(fn), ())
        if ds:
            name, line = ds[0]
            reach[id(fn)] = (
                name,
                f"{fn.qual} ({fn.module.path}:{line})",
            )
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
                    reach[fid] = (got[0], f"{fn.qual} -> {got[1]}")
                    changed = True
                    break
        if not changed:
            break
    return reach


def _stmts_reach_collective(walker, reach, stmts):
    """Earliest collective a statement list reaches (directly or via
    a resolved callee): ``(name, chain)`` or None."""
    hits = []
    for call in _calls_lexical(stmts):
        name = _collective_name(walker, call)
        if name is not None:
            hits.append(
                (
                    call.lineno,
                    name,
                    f"{walker.fn.qual} "
                    f"({walker.mod.path}:{call.lineno})",
                )
            )
            continue
        callee = walker.resolve_callee(call.func)
        if callee is not None:
            got = reach.get(id(callee))
            if got is not None:
                hits.append(
                    (call.lineno, got[0], f"{walker.fn.qual} -> {got[1]}")
                )
    if not hits:
        return None
    _line, name, chain = min(hits)
    return name, chain


# -- RT401 ------------------------------------------------------------


def _child_bodies(stmt):
    for attr in ("body", "orelse", "finalbody"):
        body = getattr(stmt, attr, None)
        if body:
            yield body
    for h in getattr(stmt, "handlers", ()) or ():
        if h.body:
            yield h.body


def _has_early_exit(stmt: ast.stmt) -> bool:
    for br in (stmt.body, getattr(stmt, "orelse", [])):
        for n in _stmts_walk(br):
            if isinstance(n, (ast.Return, ast.Raise)):
                return True
    return False


def _rt401(program: Program, walkers, reach):
    findings = []
    for fn in program.functions:
        w = walkers[id(fn)]
        tainted = _taint_map(w)

        def scan(body, w=w, tainted=tainted):
            for i, stmt in enumerate(body):
                if isinstance(stmt, (ast.If, ast.While)):
                    reason = _divergence_in(w, stmt.test, tainted)
                    if reason is not None:
                        hit = _stmts_reach_collective(
                            w, reach, stmt.body
                        ) or _stmts_reach_collective(
                            w, reach, stmt.orelse
                        )
                        if hit is None and _has_early_exit(stmt):
                            # divergent early exit: ranks that leave
                            # here never reach the collectives below
                            hit = _stmts_reach_collective(
                                w, reach, body[i + 1:]
                            )
                        if hit is not None:
                            name, chain = hit
                            findings.append(
                                _mk(
                                    RT401DivergentCollective,
                                    w.mod.path,
                                    stmt,
                                    f"rank-divergent condition "
                                    f"({reason}) guards a path that "
                                    f"reaches collective {name} (via "
                                    f"{chain}); ranks that branch "
                                    f"differently hang the gang at "
                                    f"the collective",
                                )
                            )
                if isinstance(
                    stmt,
                    (ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.ClassDef),
                ):
                    continue
                for sub in _child_bodies(stmt):
                    scan(sub)

        scan(fn.node.body)
    return findings


# -- RT402 ------------------------------------------------------------


def _branch_seq(walker, seqs, stmts) -> tuple:
    """Lexical collective sequence of a statement list, splicing in
    resolved callees' (current) sequences."""
    out: list[str] = []
    for call in _calls_lexical(stmts):
        name = _collective_name(walker, call)
        if name is not None:
            out.append(name)
            continue
        callee = walker.resolve_callee(call.func)
        if callee is not None:
            out.extend(seqs.get(id(callee), ()))
        if len(out) >= _SEQ_CAP:
            break
    return tuple(out[:_SEQ_CAP])


def _collective_seqs(program: Program, walkers) -> dict:
    """fid -> lexical collective sequence, to a fixed point."""
    seqs = {id(fn): () for fn in program.functions}
    for _ in range(12):
        changed = False
        for fn in program.functions:
            s = _branch_seq(walkers[id(fn)], seqs, fn.node.body)
            if s != seqs[id(fn)]:
                seqs[id(fn)] = s
                changed = True
        if not changed:
            break
    return seqs


def _rt402(program: Program, walkers, seqs):
    findings = []
    for fn in program.functions:
        w = walkers[id(fn)]
        for stmt in _stmts_walk(fn.node.body):
            if not isinstance(stmt, ast.If) or not stmt.orelse:
                continue
            a = _branch_seq(w, seqs, stmt.body)
            b = _branch_seq(w, seqs, stmt.orelse)
            common = set(a) & set(b)
            if not common:
                continue
            fa = [x for x in a if x in common]
            fb = [x for x in b if x in common]
            if fa == fb:
                continue
            findings.append(
                _mk(
                    RT402CollectiveOrder,
                    w.mod.path,
                    stmt,
                    f"sibling branches of {fn.qual} issue collectives "
                    f"in different orders: if-branch "
                    f"[{' -> '.join(a)}] vs else-branch "
                    f"[{' -> '.join(b)}]; if ranks disagree on the "
                    f"condition the mismatched order deadlocks the "
                    f"gang",
                )
            )
    return findings


# -- shared reachability (RT404, RT512) ----------------------------


def _closure_from(program: Program, roots) -> dict:
    """fid -> (FunctionInfo, chain string) for every function
    reachable from ``roots`` through resolved call edges (BFS)."""
    callees: dict[int, list] = {}
    for fn, callee, _node, _held in program.calls:
        callees.setdefault(id(fn), []).append(callee)
    out: dict[int, tuple] = {}
    frontier = [(fn, fn.qual) for fn in roots]
    for fn, chain in frontier:
        out.setdefault(id(fn), (fn, chain))
    while frontier:
        nxt = []
        for fn, chain in frontier:
            for callee in callees.get(id(fn), ()):
                if id(callee) in out:
                    continue
                c = f"{chain} -> {callee.qual}"
                out[id(callee)] = (callee, c)
                nxt.append((callee, c))
        frontier = nxt
    return out


# -- RT404 ------------------------------------------------------------


def _gang_modules(program: Program) -> list:
    return [
        mod
        for mod in program.modules
        if any(a == "parallel.gang" or a == "gang" for a in mod.aliases)
    ]


def _rt404(program: Program, walkers):
    findings = []
    gang_fns = [
        fn
        for fn in program.functions
        if fn.module in _gang_modules(program)
    ]
    closure = _closure_from(program, gang_fns)
    for fn, chain in closure.values():
        for call in _calls_lexical(fn.node.body):
            if not (
                isinstance(call.func, ast.Attribute)
                and call.func.attr == "record_event"
            ):
                continue
            if any(k.arg == "gang_epoch" for k in call.keywords):
                continue
            if any(k.arg is None for k in call.keywords):
                continue  # **kwargs forwarding: cannot prove untagged
            via = (
                f" (reached via {chain})"
                if fn.module not in _gang_modules(program)
                else ""
            )
            findings.append(
                _mk(
                    RT404UntaggedJournalWrite,
                    fn.module.path,
                    call,
                    f"record_event() on a gang execution path "
                    f"without a gang_epoch= tag{via}: replay after a "
                    f"rank loss cannot fence this event",
                )
            )
    return findings


# -- entry point ------------------------------------------------------


def run_spmd(paths, select=None, built=None) -> list[Finding]:
    """Run the RT40x whole-program pass; returns filtered findings.
    ``built``: as for
    :func:`~repic_tpu_torch.analysis.concurrency.run_concurrency`."""
    program, errors = built if built is not None else build_program(paths)
    walkers = {
        id(fn): _FnWalker(program, fn) for fn in program.functions
    }
    direct = {
        id(fn): _direct_collectives(walkers[id(fn)])
        for fn in program.functions
    }
    reach = _collective_reach(program, direct)
    seqs = _collective_seqs(program, walkers)
    raw = (
        _rt401(program, walkers, reach)
        + _rt402(program, walkers, seqs)
        + _rt404(program, walkers)
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
