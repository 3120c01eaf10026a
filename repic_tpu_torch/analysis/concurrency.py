"""Whole-program concurrency analysis: the RT3xx rule pack (the port
of ``repic_tpu.analysis.concurrency``, whole: the pass lints Python
threads and is free of JAX idiom).

The port is a threaded system -- cluster heartbeat daemons, the
streaming metric flusher, the ``--status-port`` server, the ``serve``
worker/queue/breaker, the fleet and the gang watchdog -- but the
per-file lint (RT004/RT2xx) reasons about one module at a time.  This
pass closes the gap: it parses EVERY module under the given paths into
one :class:`Program`, resolves classes, attribute types, and callees
across module boundaries (via each module's import map, the same
canonicalization the per-file engine uses), and checks the
coordination layer's invariants:

RT301  shared mutable state written without its guarding lock.  Guard
       sets are INFERRED: an attribute (or module global) written
       somewhere under ``with <lock>:`` is lock-guarded state; any
       other writer that holds no lock is flagged.  Constructor writes
       and writes to objects constructed in the same function are
       initialization, not sharing.
RT302  inconsistent lock-acquisition order.  Every ``with`` lock
       acquisition (``threading.Lock``/``RLock`` attributes, module-
       global locks, ``runtime.atomic.file_lock``) while another lock
       is held adds an edge to a program-wide lock graph — including
       acquisitions made by CALLEES of the holding region, resolved
       through attribute types and return annotations.  A cycle is a
       potential deadlock; acquiring a non-reentrant lock you already
       hold is an immediate one.
RT303  blocking call while holding a lock: ``time.sleep``, file
       ``flush``/``os.fsync``, subprocess spawns, ``urlopen``,
       ``Thread.join``/``Event.wait``, ``torch.cuda.synchronize``,
       ``sync_device`` — directly or
       via a resolved callee.  A stalled I/O under a hot lock stalls
       every thread behind it.  ``file_lock`` is exempt as the HELD
       lock (serializing I/O is its purpose) but still participates
       in the RT302 graph.
RT304  thread-lifecycle hygiene: a non-daemon ``threading.Thread``
       that is never joined (process exit hangs on it), and thread
       targets with an Event-less ``while True: ... time.sleep(...)``
       stop loop (the thread can never be stopped deterministically).
RT305  signal-handler safety: a handler registered via
       ``signal.signal`` may only do async-signal-safe work — set an
       ``Event``/flag or ``os._exit``.  Locks, I/O, or journal writes
       in a handler deadlock or corrupt state when the signal lands
       on the wrong instruction.

The static half is cross-checked dynamically: the opt-in
``REPIC_TPU_LOCKCHECK=1`` sanitizer
(:mod:`repic_tpu_torch.analysis.lockcheck`) records real lock acquisition
order during the tier-1 suite and fails on a cycle or an
unguarded-write witness — see docs/static_analysis.md.

Like the per-file lint this pass imports no torch and no target
module: pure ``ast`` over source text, safe and sub-second in any CI
container.  Resolution is conservative — an unresolvable callee or
receiver type produces no finding, never a guess.  Suppress with
``# repic: noqa[RT30x]`` on the finding's line, the decorator line of
its function, or the ``with`` line of the held lock it reports.
"""

from __future__ import annotations

import ast
import os

from repic_tpu_torch.analysis.engine import (
    Finding,
    ImportMap,
    Rule,
    _line_suppresses,
    call_span_map,
    decorator_line_map,
    dedupe_findings,
    iter_python_files,
)

# -- rule metadata ----------------------------------------------------


class RT301UnguardedWrite(Rule):
    rule_id = "RT301"
    severity = "error"
    title = "shared mutable state written without its guarding lock"
    hint = (
        "hold the same lock the other writers of this attribute hold "
        "(or, if the path is provably single-threaded, justify with "
        "# repic: noqa[RT301] and a comment)"
    )


class RT302LockOrder(Rule):
    rule_id = "RT302"
    severity = "error"
    title = "inconsistent lock-acquisition order (potential deadlock)"
    hint = (
        "pick one global acquisition order and release the outer lock "
        "before taking the inner one on the reversed path; RLock only "
        "fixes SELF-reentrancy, not cross-lock cycles"
    )


class RT303BlockingUnderLock(Rule):
    rule_id = "RT303"
    severity = "warning"
    title = "blocking call while holding a lock"
    hint = (
        "move the blocking work (sleep, flush/fsync, join/wait, "
        "subprocess, device sync) outside the critical section, or "
        "justify with # repic: noqa[RT303] on the call or the `with` "
        "line when serializing the I/O is the lock's purpose"
    )


class RT304ThreadLifecycle(Rule):
    rule_id = "RT304"
    severity = "warning"
    title = "thread-lifecycle hygiene (join/daemon/stop-event)"
    hint = (
        "daemon=True for fire-and-forget threads, join() for "
        "non-daemon ones; loop on `while not stop_event.wait(dt)` "
        "instead of `while True: ... time.sleep(dt)` so the thread "
        "can be stopped deterministically"
    )


class RT305SignalHandler(Rule):
    rule_id = "RT305"
    severity = "error"
    title = "non-async-signal-safe work in a signal handler"
    hint = (
        "a signal handler may only set an Event/flag (or os._exit); "
        "do the real shutdown work in the main loop that observes the "
        "flag (see serve.daemon.install_signal_handlers)"
    )


CONCURRENCY_RULES = {
    r.rule_id: r
    for r in (
        RT301UnguardedWrite,
        RT302LockOrder,
        RT303BlockingUnderLock,
        RT304ThreadLifecycle,
        RT305SignalHandler,
    )
}

# -- canonical names --------------------------------------------------

LOCK_FACTORIES = {"threading.Lock": "lock", "threading.RLock": "rlock"}
EVENT_FACTORIES = {"threading.Event", "threading.Condition"}
THREAD_FACTORY = "threading.Thread"
#: one program-wide node for the cross-process flock
#: (:func:`repic_tpu_torch.runtime.atomic.file_lock`)
FILE_LOCK_ID = "repic_tpu_torch.runtime.atomic.file_lock"

#: fully-resolved calls that block the calling thread
BLOCKING_CALLS = {
    "time.sleep": "time.sleep()",
    "os.fsync": "os.fsync()",
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_call": "subprocess.check_call()",
    "subprocess.check_output": "subprocess.check_output()",
    "subprocess.Popen": "subprocess.Popen()",
    "urllib.request.urlopen": "urllib.request.urlopen()",
    "socket.create_connection": "socket.create_connection()",
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
}

#: attribute-tail calls that block regardless of receiver type
BLOCKING_TAILS = {
    "flush": "file flush()",
    "fsync": "fsync()",
    "sync_device": "sync_device()",
    # a CUDA stream's or event's synchronize() waits for the card
    "synchronize": "synchronize()",
}

#: methods that mutate their receiver in place
MUTATORS = {
    "append", "extend", "add", "discard", "remove", "pop", "popitem",
    "clear", "update", "insert", "setdefault", "appendleft",
    "popleft", "sort",
}

_INIT_METHODS = {"__init__", "__new__", "__post_init__"}

#: method names too generic for the unique-method-name fallback:
#: dict/list/set/file/thread protocol names that an UNTYPED receiver
#: (a dict, a file handle) shares with project classes.  Resolving
#: ``self._fh.write`` to the one project class defining ``write``
#: fabricates call edges; better to not resolve at all.
_PROTOCOL_NAMES = {
    "get", "set", "put", "add", "pop", "clear", "copy", "update",
    "append", "extend", "remove", "discard", "insert", "sort",
    "index", "count", "items", "keys", "values", "setdefault",
    "read", "write", "close", "open", "flush", "seek", "tell",
    "readline", "readlines", "writelines", "send", "recv",
    "start", "stop", "run", "join", "wait", "acquire", "release",
    "format", "split", "strip", "encode", "decode", "record",
}


def _dump(node: ast.AST) -> str:
    return ast.dump(node)


def _qualify(mod, dotted: str | None) -> str | None:
    """Prefix a bare same-module name with its module: ``_Instrument``
    inside ``telemetry/metrics.py`` becomes
    ``repic_tpu_torch.telemetry.metrics._Instrument`` so
    :meth:`Program.resolve_dotted` (which needs a module prefix) can
    chase it.  Dotted and unknown names pass through unchanged."""
    if dotted and "." not in dotted and (
        dotted in mod.classes or dotted in mod.functions
    ):
        return f"{mod.name}.{dotted}"
    return dotted


# -- program model ----------------------------------------------------


class FunctionInfo:
    """One analyzed function/method (top-level, class, or nested)."""

    def __init__(self, module, cls, name, node):
        self.module = module
        self.cls = cls                     # ClassInfo | None
        self.name = name
        self.node = node
        owner = cls.qual if cls else module.name
        self.qual = f"{owner}.{name}"
        # filled by the walker / later passes
        self.entry_held: frozenset = frozenset()


class ClassInfo:
    """One analyzed class: locks, attribute types, methods, bases."""

    def __init__(self, module, node):
        self.module = module
        self.name = node.name
        self.node = node
        self.qual = f"{module.name}.{node.name}"
        self.base_names = [
            module.imports.resolve(b) for b in node.bases
        ]
        self.bases: list = []            # ClassInfo, resolved later
        self.lock_attrs: dict[str, str] = {}      # attr -> kind
        self.event_attrs: set = set()
        self.thread_attrs: set = set()
        self.attr_types: dict[str, str] = {}      # attr -> dotted
        self.methods: dict[str, FunctionInfo] = {}

    def mro(self, _depth=0):
        """This class plus resolved bases, most-derived first."""
        out = [self]
        if _depth > 8:
            return out
        for b in self.bases:
            for c in b.mro(_depth + 1):
                if c not in out:
                    out.append(c)
        return out

    def find_lock_attr(self, attr):
        for c in self.mro():
            if attr in c.lock_attrs:
                return c, c.lock_attrs[attr]
        return None, None

    def find_attr_type(self, attr):
        for c in self.mro():
            if attr in c.attr_types:
                return c.attr_types[attr]
            if attr in c.event_attrs:
                return "threading.Event"
            if attr in c.thread_attrs:
                return "threading.Thread"
        return None

    def find_method(self, name):
        for c in self.mro():
            if name in c.methods:
                return c.methods[name]
        return None


class ModuleInfo:
    """One parsed module plus its name aliases and indexes."""

    def __init__(self, path, source, tree):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.imports = ImportMap(tree)
        self.aliases = _module_aliases(path)
        self.name = self.aliases[0]
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.global_locks: dict[str, str] = {}    # name -> kind
        self.global_types: dict[str, str] = {}    # name -> dotted
        self.global_names: set = set()            # module-level binds
        self.dec_map = decorator_line_map(tree)
        self.span_map = call_span_map(tree)


def _module_aliases(path: str) -> list[str]:
    parts = path.replace("\\", "/").split("/")
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    parts = [p for p in parts if p and p != "."]
    if "repic_tpu_torch" in parts:
        parts = parts[parts.index("repic_tpu_torch"):]
    else:
        parts = parts[-4:]
    return [".".join(parts[i:]) for i in range(len(parts))] or [path]


class Program:
    """The whole-program view every RT3xx rule reads."""

    def __init__(self):
        self.modules: list[ModuleInfo] = []
        self.by_alias: dict[str, ModuleInfo] = {}
        self.by_path: dict[str, ModuleInfo] = {}
        self.classes_by_qual: dict[str, ClassInfo] = {}
        self.methods_by_name: dict[str, list[FunctionInfo]] = {}
        self.functions: list[FunctionInfo] = []
        # walker output (program-wide)
        self.writes = []        # (owner_key, attr, node, held, fn,
        #                          is_init, constructed)
        self.blocking = []      # (desc, node, held, fn)
        self.calls = []         # (fn, callee FunctionInfo, node, held)
        self.edges = {}         # (src, dst) -> (path, line, via)
        self.self_deadlocks = []  # (lock, node, fn)
        self.lock_kinds: dict[str, str] = {FILE_LOCK_ID: "lock"}
        self.threads = []       # (node, daemon, target_fn, slot, fn)
        self.joined_slots: set = set()
        self.handlers = []      # (handler_node, fn_or_None, site, mod)

    # -- registration -------------------------------------------------

    def add_module(self, mod: ModuleInfo) -> None:
        self.modules.append(mod)
        self.by_path[mod.path] = mod
        for a in mod.aliases:
            self.by_alias.setdefault(a, mod)

    def index_module(self, mod: ModuleInfo) -> None:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                ci = ClassInfo(mod, node)
                mod.classes[ci.name] = ci
                self.classes_by_qual[ci.qual] = ci
                for sub in node.body:
                    if isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        fi = FunctionInfo(mod, ci, sub.name, sub)
                        ci.methods[sub.name] = fi
                        self.functions.append(fi)
                        self.methods_by_name.setdefault(
                            sub.name, []
                        ).append(fi)
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                fi = FunctionInfo(mod, None, node.name, node)
                mod.functions[node.name] = fi
                self.functions.append(fi)
            elif isinstance(node, ast.Assign) and len(
                node.targets
            ) == 1 and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                mod.global_names.add(name)
                val = node.value
                if isinstance(val, ast.Call):
                    target = mod.imports.resolve(val.func)
                    if target in LOCK_FACTORIES:
                        mod.global_locks[name] = LOCK_FACTORIES[target]
            elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name
            ):
                mod.global_names.add(node.target.id)
                t = _annotation_dotted(mod, node.annotation)
                if t:
                    mod.global_types[node.target.id] = t

    def link(self) -> None:
        """Resolve base classes and attribute types across modules."""
        for mod in self.modules:
            for ci in mod.classes.values():
                for bn in ci.base_names:
                    base = self.resolve_class(_qualify(mod, bn))
                    if base is not None:
                        ci.bases.append(base)
        # typed module globals: `REGISTRY = MetricsRegistry()` and
        # factory-returned instruments (`X = telemetry.counter(...)`
        # via the factory's return annotation)
        for mod in self.modules:
            for node in mod.tree.body:
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)
                ):
                    continue
                t = self._call_result_type(mod, node.value)
                if t:
                    mod.global_types[node.targets[0].id] = t
        # class attribute discovery needs bases + globals resolved
        for mod in self.modules:
            for ci in mod.classes.values():
                for m in ci.methods.values():
                    self._scan_attr_assigns(ci, m)

    # -- name resolution ----------------------------------------------

    def resolve_dotted(self, dotted: str, _depth=0):
        """Chase a canonical dotted path to a class or function.

        Follows re-export chains (``repic_tpu_torch.telemetry.counter`` ->
        ``repic_tpu_torch.telemetry.metrics.counter``) via each module's
        import map.  Returns ``("class", ClassInfo)``,
        ``("func", FunctionInfo)``, or ``None``.
        """
        if not dotted or _depth > 6:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.by_alias.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            head = rest[0]
            if head in mod.classes:
                return ("class", mod.classes[head])
            if head in mod.functions and len(rest) == 1:
                return ("func", mod.functions[head])
            mapped = mod.imports.names.get(head)
            if mapped and mapped != dotted:
                return self.resolve_dotted(
                    ".".join([mapped] + rest[1:]), _depth + 1
                )
            return None
        return None

    def resolve_class(self, dotted) -> ClassInfo | None:
        got = self.resolve_dotted(dotted) if dotted else None
        return got[1] if got and got[0] == "class" else None

    def global_lock_by_dotted(self, dotted, _depth=0):
        """Resolve an IMPORTED module-global lock (``from pkg.b
        import LOCK_B``) to its canonical ``(lock_id, kind)`` — the
        id uses the DEFINING module's name so both modules' uses of
        one lock are one graph node."""
        if not dotted or "." not in dotted or _depth > 6:
            return None
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            mod = self.by_alias.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if len(rest) == 1 and rest[0] in mod.global_locks:
                return (
                    f"{mod.name}.{rest[0]}",
                    mod.global_locks[rest[0]],
                )
            mapped = mod.imports.names.get(rest[0])
            if mapped and mapped != dotted:
                return self.global_lock_by_dotted(
                    ".".join([mapped] + rest[1:]), _depth + 1
                )
            return None
        return None

    def _call_result_type(self, mod, call: ast.Call) -> str | None:
        """Dotted type of a call's result: constructor, or a function
        with a class-valued return annotation."""
        dotted = _qualify(mod, mod.imports.resolve(call.func))
        if not dotted:
            return None
        got = self.resolve_dotted(dotted)
        if got is None:
            return None
        if got[0] == "class":
            return got[1].qual
        fn = got[1]
        returns = getattr(fn.node, "returns", None)
        if returns is not None:
            return _annotation_dotted(fn.module, returns)
        return None

    # -- class attribute discovery ------------------------------------

    def _scan_attr_assigns(self, ci: ClassInfo, m: FunctionInfo):
        """Record ``self.X = <lock/event/thread/typed>`` in a method."""
        mod = ci.module
        param_types = _param_types(mod, m.node, self)
        for node in ast.walk(m.node):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign):
                targets, value = [node.target], node.value
                ann = _annotation_dotted(mod, node.annotation)
                if ann and _is_self_attr(targets[0]):
                    self._classify_attr(ci, targets[0].attr, ann)
            else:
                continue
            for t in targets:
                if not _is_self_attr(t):
                    continue
                dotted = self._value_dotted(
                    mod, value, param_types
                )
                if dotted:
                    self._classify_attr(ci, t.attr, dotted)

    def _value_dotted(self, mod, value, param_types) -> str | None:
        if value is None:
            return None
        if isinstance(value, ast.Call):
            dotted = mod.imports.resolve(value.func)
            if dotted in LOCK_FACTORIES or dotted in EVENT_FACTORIES \
                    or dotted == THREAD_FACTORY:
                return dotted
            return self._call_result_type(mod, value)
        if isinstance(value, ast.Name):
            return param_types.get(value.id)
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                got = self._value_dotted(mod, v, param_types)
                if got:
                    return got
        return None

    def _classify_attr(self, ci: ClassInfo, attr, dotted) -> None:
        if dotted in LOCK_FACTORIES:
            ci.lock_attrs[attr] = LOCK_FACTORIES[dotted]
            self.lock_kinds[f"{ci.qual}.{attr}"] = (
                LOCK_FACTORIES[dotted]
            )
        elif dotted in EVENT_FACTORIES:
            ci.event_attrs.add(attr)
        elif dotted == THREAD_FACTORY:
            ci.thread_attrs.add(attr)
        else:
            ci.attr_types.setdefault(attr, dotted)


def _is_self_attr(node) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _annotation_dotted(mod, node, _depth=0) -> str | None:
    """First concrete dotted type in an annotation (``C | None``,
    ``Optional[C]``, and string annotations all yield ``C``)."""
    if node is None or _depth > 4:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_dotted(
            mod, node.left, _depth + 1
        ) or _annotation_dotted(mod, node.right, _depth + 1)
    if isinstance(node, ast.Subscript):
        return _annotation_dotted(mod, node.slice, _depth + 1)
    if isinstance(node, (ast.Name, ast.Attribute)):
        dotted = mod.imports.resolve(node)
        if dotted in ("None", "builtins.None"):
            return None
        return _qualify(mod, dotted)
    return None


def _param_types(mod, fn_node, program) -> dict[str, str]:
    out = {}
    args = fn_node.args
    for a in list(args.posonlyargs) + list(args.args) + list(
        args.kwonlyargs
    ):
        t = _annotation_dotted(mod, a.annotation)
        if t:
            out[a.arg] = t
    return out


# -- the per-function walker ------------------------------------------


class _Held:
    __slots__ = ("lock", "kind", "dump", "node")

    def __init__(self, lock, kind, dump, node):
        self.lock = lock
        self.kind = kind
        self.dump = dump
        self.node = node


class _FnWalker:
    """One pass over a function body: locks held, writes, calls,
    blocking ops, thread/handler registrations."""

    def __init__(self, program: Program, fn: FunctionInfo):
        self.program = program
        self.fn = fn
        self.mod = fn.module
        self.cls = fn.cls
        self.types: dict[str, str] = _param_types(
            self.mod, fn.node, program
        )
        if fn.cls is not None:
            self.types["self"] = fn.cls.qual
        self.local_funcs: dict[str, FunctionInfo] = {}
        self.locals_bound: set = set()
        self.constructed: set = set()
        self._prescan(fn.node)

    def _prescan(self, fn_node) -> None:
        """Flow-insensitive local typing: collect every local binding
        before the main walk, so use-before-def ordering never loses a
        type (and locals shadowing globals are known)."""
        for node in _walk_skip_nested(fn_node):
            if isinstance(node, ast.Assign):
                tgts = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                tgts = [node.target]
            elif isinstance(node, (ast.For,)):
                tgts = [node.target]
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        self.locals_bound.add(n.id)
                continue
            elif isinstance(node, ast.withitem):
                if node.optional_vars is not None:
                    for n in ast.walk(node.optional_vars):
                        if isinstance(n, ast.Name):
                            self.locals_bound.add(n.id)
                continue
            else:
                continue
            value = getattr(node, "value", None)
            for t in tgts:
                if not isinstance(t, ast.Name):
                    continue
                self.locals_bound.add(t.id)
                if value is None:
                    continue
                if isinstance(node, ast.AnnAssign):
                    ann = _annotation_dotted(self.mod, node.annotation)
                    if ann:
                        self.types[t.id] = ann
                dotted = self.program._value_dotted(
                    self.mod, value, self.types
                )
                if dotted:
                    self.types.setdefault(t.id, dotted)
                if isinstance(value, ast.Call):
                    got = self.program.resolve_dotted(
                        _qualify(
                            self.mod,
                            self.mod.imports.resolve(value.func),
                        )
                        or ""
                    )
                    if got and got[0] == "class":
                        self.constructed.add(t.id)

    # -- type/lock resolution -----------------------------------------

    def expr_type(self, node, _depth=0) -> str | None:
        if _depth > 6:
            return None
        if isinstance(node, ast.Name):
            if node.id in self.types:
                return self.types[node.id]
            if node.id not in self.locals_bound:
                return self.mod.global_types.get(node.id)
            return None
        if isinstance(node, ast.Attribute):
            owner_t = self.expr_type(node.value, _depth + 1)
            ci = self.program.resolve_class(owner_t) if owner_t else None
            if ci is not None:
                return ci.find_attr_type(node.attr)
            return None
        if isinstance(node, ast.Call):
            return self.program._call_result_type(self.mod, node)
        return None

    def lock_of(self, node) -> _Held | None:
        """Resolve a ``with`` item to a lock identity, or None."""
        if isinstance(node, ast.Call):
            dotted = self.mod.imports.resolve(node.func) or ""
            if dotted == FILE_LOCK_ID or dotted.endswith(".file_lock") \
                    or dotted == "file_lock":
                return _Held(FILE_LOCK_ID, "lock", _dump(node), node)
            return None
        if isinstance(node, ast.Name):
            kind = None
            if node.id in self.types and self.types[node.id] in (
                "threading.Lock", "threading.RLock"
            ):
                kind = LOCK_FACTORIES[self.types[node.id]]
                lock = f"{self.fn.qual}.{node.id}"
            elif node.id not in self.locals_bound and (
                node.id in self.mod.global_locks
            ):
                kind = self.mod.global_locks[node.id]
                lock = f"{self.mod.name}.{node.id}"
            elif node.id not in self.locals_bound:
                # a lock imported from ANOTHER module: canonicalize
                # to the defining module so both sides share a node
                got = self.program.global_lock_by_dotted(
                    self.mod.imports.resolve(node)
                )
                if got is not None:
                    lock, kind = got
            if kind is None:
                return None
            self.program.lock_kinds[lock] = kind
            return _Held(lock, kind, _dump(node), node)
        if isinstance(node, ast.Attribute):
            owner_t = self.expr_type(node.value)
            ci = self.program.resolve_class(owner_t) if owner_t else None
            if ci is None:
                return None
            base, kind = ci.find_lock_attr(node.attr)
            if base is None:
                return None
            lock = f"{base.qual}.{node.attr}"
            self.program.lock_kinds[lock] = kind
            return _Held(lock, kind, _dump(node), node)
        return None

    def resolve_callee(self, func_node) -> FunctionInfo | None:
        dotted = _qualify(
            self.mod, self.mod.imports.resolve(func_node)
        )
        if dotted:
            got = self.program.resolve_dotted(dotted)
            if got is not None:
                if got[0] == "func":
                    return got[1]
                return got[1].find_method("__init__")
        if isinstance(func_node, ast.Attribute):
            owner_t = self.expr_type(func_node.value)
            ci = (
                self.program.resolve_class(owner_t)
                if owner_t else None
            )
            if ci is not None:
                return ci.find_method(func_node.attr)
            # unique-method-name fallback: safe only when exactly one
            # class in the program defines this method name AND the
            # name is distinctive (not a builtin-protocol name an
            # untyped dict/file/thread receiver would also have)
            if func_node.attr in _PROTOCOL_NAMES:
                return None
            cands = self.program.methods_by_name.get(
                func_node.attr, []
            )
            if len(cands) == 1:
                return cands[0]
            return None
        if isinstance(func_node, ast.Name):
            if func_node.id in self.local_funcs:
                return self.local_funcs[func_node.id]
            if func_node.id not in self.locals_bound:
                return self.mod.functions.get(func_node.id)
        return None

    # -- main walk ----------------------------------------------------

    def walk(self) -> None:
        self._stmts(self.fn.node.body, [])

    def _stmts(self, body, held) -> None:
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, stmt, held) -> None:
        p, fn = self.program, self.fn
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in stmt.items:
                self._expr(item.context_expr, new_held)
                got = self.lock_of(item.context_expr)
                if got is None:
                    continue
                for h in new_held:
                    if h.lock == got.lock:
                        if got.kind != "rlock" and h.dump == got.dump:
                            p.self_deadlocks.append(
                                (got.lock, item.context_expr, fn)
                            )
                        continue
                    p.edges.setdefault(
                        (h.lock, got.lock),
                        (
                            self.mod.path,
                            item.context_expr.lineno,
                            fn.qual,
                        ),
                    )
                new_held.append(got)
            self._stmts(stmt.body, new_held)
        elif isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            nested = FunctionInfo(self.mod, self.cls, stmt.name, stmt)
            self.local_funcs[stmt.name] = nested
            p.functions.append(nested)
            sub = _FnWalker(p, nested)
            sub.types.update(
                {k: v for k, v in self.types.items() if k != "self"}
            )
            sub.local_funcs.update(self.local_funcs)
            sub.walk()
        elif isinstance(stmt, ast.ClassDef):
            for s in stmt.body:
                if isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    nested = FunctionInfo(
                        self.mod, self.cls, s.name, s
                    )
                    p.functions.append(nested)
                    _FnWalker(p, nested).walk()
        elif isinstance(stmt, ast.Assign):
            self._expr(stmt.value, held)
            for t in stmt.targets:
                self._write_target(t, held)
            self._maybe_thread(stmt.value, stmt.targets, held)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._expr(stmt.value, held)
                self._write_target(stmt.target, held)
                self._maybe_thread(stmt.value, [stmt.target], held)
        elif isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value, held)
            self._write_target(stmt.target, held)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._write_target(t, held)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value, held)
            if isinstance(stmt.value, ast.Call):
                self._maybe_thread(stmt.value, [], held)
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test, held)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
        elif isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
        elif isinstance(stmt, ast.For):
            self._expr(stmt.iter, held)
            self._stmts(stmt.body, held)
            self._stmts(stmt.orelse, held)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body, held)
            for h in stmt.handlers:
                self._stmts(h.body, held)
            self._stmts(stmt.orelse, held)
            self._stmts(stmt.finalbody, held)
        elif isinstance(stmt, (ast.Return, ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, held)
        elif isinstance(stmt, ast.Global):
            pass
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, held)

    # -- expression handling ------------------------------------------

    def _expr(self, node, held) -> None:
        """Record calls and blocking ops inside one expression.

        Lambda bodies are DEFERRED code — their calls do not run here,
        so they are skipped (the RT305 pass inspects handler lambdas
        separately)."""
        if node is None:
            return
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                self._call(n, held)
            stack.extend(ast.iter_child_nodes(n))

    def _call(self, node: ast.Call, held) -> None:
        p, mod = self.program, self.mod
        dotted = mod.imports.resolve(node.func) or ""
        # blocking classification
        desc = BLOCKING_CALLS.get(dotted)
        if desc is None and dotted.endswith(".sync_device"):
            desc = "sync_device()"
        if desc is None and isinstance(node.func, ast.Attribute):
            tail = node.func.attr
            if tail in BLOCKING_TAILS:
                desc = BLOCKING_TAILS[tail]
            elif tail in ("join", "wait"):
                t = self.expr_type(node.func.value)
                if tail == "join" and t == "threading.Thread":
                    desc = "Thread.join()"
                elif tail == "wait" and t in EVENT_FACTORIES:
                    desc = "Event.wait()"
            if tail == "join":
                # a join makes the thread's lifecycle sound (RT304)
                # even when the join itself is also a blocking op
                # (RT303's concern, handled via desc above)
                slot = self._slot_of(node.func.value)
                if slot is not None:
                    p.joined_slots.add(slot)
            if tail in MUTATORS:
                self._mutation(node.func.value, node, held)
        if desc is not None:
            p.blocking.append((desc, node, tuple(held), self.fn))
        # signal handler registration
        if dotted == "signal.signal" and len(node.args) == 2:
            handler = node.args[1]
            target = None
            if not isinstance(handler, ast.Lambda):
                target = self.resolve_callee(handler)
                if target is None:
                    handler = None
            if handler is not None or target is not None:
                p.handlers.append((handler, target, node, mod))
        # thread join via direct attribute (self._thread.join())
        callee = self.resolve_callee(node.func)
        if callee is not None:
            p.calls.append((self.fn, callee, node, tuple(held)))

    def _slot_of(self, node):
        """Stable identity of where a Thread object is stored."""
        if isinstance(node, ast.Attribute):
            owner_t = self.expr_type(node.value)
            ci = (
                self.program.resolve_class(owner_t)
                if owner_t else None
            )
            if ci is not None:
                return (ci.mro()[-1].qual, node.attr)
            if _is_self_attr(node) and self.cls is not None:
                return (self.cls.mro()[-1].qual, node.attr)
            return None
        if isinstance(node, ast.Name):
            return (self.fn.qual, node.id)
        return None

    def _maybe_thread(self, value, targets, held) -> None:
        if not (
            isinstance(value, ast.Call)
            and self.mod.imports.resolve(value.func) == THREAD_FACTORY
        ):
            return
        daemon = None
        target_fn = None
        for kw in value.keywords:
            if kw.arg == "daemon" and isinstance(
                kw.value, ast.Constant
            ):
                daemon = bool(kw.value.value)
            if kw.arg == "target":
                target_fn = self.resolve_callee(kw.value)
        slot = None
        for t in targets:
            slot = self._slot_of(t) or slot
        self.program.threads.append(
            (value, daemon, target_fn, slot, self.fn)
        )

    # -- writes -------------------------------------------------------

    def _write_target(self, node, held) -> None:
        if isinstance(node, ast.Tuple):
            for e in node.elts:
                self._write_target(e, held)
            return
        if isinstance(node, ast.Subscript):
            self._mutation(node.value, node, held)
            return
        if isinstance(node, ast.Attribute):
            self._attr_write(node, node, held)
            return
        if isinstance(node, ast.Name):
            self._global_write(node, node, held)

    def _mutation(self, receiver, site, held) -> None:
        """An in-place mutation of ``receiver`` (subscript store or a
        mutator-method call) is a write to wherever it lives."""
        if isinstance(receiver, ast.Attribute):
            self._attr_write(receiver, site, held)
        elif isinstance(receiver, ast.Name):
            self._global_write(receiver, site, held)

    def _attr_write(self, attr_node, site, held) -> None:
        base = attr_node.value
        owner_qual = None
        constructed = False
        if isinstance(base, ast.Name):
            if base.id == "self" and self.cls is not None:
                owner_qual = self.cls.qual
            else:
                owner_qual = self.expr_type(base)
                constructed = base.id in self.constructed
        else:
            owner_qual = self.expr_type(base)
        ci = (
            self.program.resolve_class(owner_qual)
            if owner_qual else None
        )
        if ci is None:
            return
        owner = _declaring_class(ci, attr_node.attr)
        # a `self.X = ...` inside __init__/__new__/__post_init__ is
        # object construction, not shared-state mutation; writes to
        # OTHER objects from a constructor are still writes
        is_init = (
            self.fn.name in _INIT_METHODS
            and isinstance(base, ast.Name)
            and base.id == "self"
        )
        self.program.writes.append(
            (
                ("class", owner.qual),
                attr_node.attr,
                site,
                tuple(held),
                self.fn,
                is_init,
                constructed,
            )
        )

    def _global_write(self, name_node, site, held) -> None:
        name = name_node.id
        if name in self.locals_bound and not self._declared_global(
            name
        ):
            return
        if name not in self.mod.global_names:
            return
        self.program.writes.append(
            (
                ("global", self.mod.name),
                name,
                site,
                tuple(held),
                self.fn,
                False,
                False,
            )
        )

    def _declared_global(self, name) -> bool:
        for n in _walk_skip_nested(self.fn.node):
            if isinstance(n, ast.Global) and name in n.names:
                return True
        return False


def _declaring_class(ci: ClassInfo, attr: str) -> ClassInfo:
    """The most basal class in the MRO that declares/types ``attr`` —
    so ``Counter._samples`` and ``_Instrument._samples`` group as one
    piece of shared state."""
    owner = ci
    for c in ci.mro():
        if (
            attr in c.attr_types
            or attr in c.lock_attrs
            or attr in c.event_attrs
            or attr in c.thread_attrs
            or any(
                _is_self_attr(t)
                and t.attr == attr
                for m in c.methods.values()
                for n in ast.walk(m.node)
                if isinstance(n, (ast.Assign, ast.AnnAssign))
                for t in (
                    n.targets
                    if isinstance(n, ast.Assign)
                    else [n.target]
                )
            )
        ):
            owner = c
    return owner


def _walk_skip_nested(fn_node):
    """Walk a function body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)
        ):
            stack.extend(ast.iter_child_nodes(n))


# -- program construction ---------------------------------------------


def build_program(paths) -> tuple[Program, list[Finding]]:
    """Parse every module under ``paths`` into one :class:`Program`.

    Returns the program plus RT000 findings for unreadable/missing
    paths (same contract as the per-file engine: a vacuous pass on a
    typo'd path must not read as a green gate).
    """
    program = Program()
    errors: list[Finding] = []
    missing: list[str] = []
    for path in iter_python_files(paths, missing=missing):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, UnicodeDecodeError, SyntaxError) as e:
            errors.append(
                Finding(
                    rule="RT000",
                    severity="error",
                    message=f"cannot analyze file: {e}",
                    hint="",
                    path=path,
                    line=getattr(e, "lineno", 1) or 1,
                    col=0,
                )
            )
            continue
        program.add_module(ModuleInfo(path, source, tree))
    for p in missing:
        errors.append(
            Finding(
                rule="RT000",
                severity="error",
                message="path does not exist",
                hint="",
                path=p,
                line=1,
                col=0,
            )
        )
    for mod in program.modules:
        program.index_module(mod)
    program.link()
    for fn in list(program.functions):
        _FnWalker(program, fn).walk()
    _compute_entry_held(program)
    _derive_call_edges(program)
    return program, errors


def _compute_entry_held(program: Program) -> None:
    """Locks held at EVERY resolved call site of a function.

    Lets helpers documented "call with the lock held" (e.g.
    ``JobQueue._note_terminal``) count as guarded: their writes are
    protected by the caller's critical section, not a lexical
    ``with`` of their own.
    """
    sites: dict[int, list[frozenset]] = {}
    for _fn, callee, _node, held in program.calls:
        sites.setdefault(id(callee), []).append(
            frozenset(h.lock for h in held)
        )
    for fn in program.functions:
        held_sets = sites.get(id(fn))
        if held_sets:
            common = frozenset.intersection(*held_sets)
            fn.entry_held = common
        else:
            fn.entry_held = frozenset()


def _transitive_acquires(program: Program) -> dict[int, set]:
    """Fixed point: every lock a function may acquire, directly or
    through resolved callees."""
    direct: dict[int, set] = {}
    callees: dict[int, set] = {}
    for fn, callee, _node, _held in program.calls:
        callees.setdefault(id(fn), set()).add(id(callee))
    for fn in program.functions:
        direct.setdefault(id(fn), set())
    # the main walk records held-transition EDGES; the fixed point
    # needs per-function acquisition SETS, re-derived with a light
    # re-walk of each function's `with` items
    for fn in program.functions:
        w = _FnWalker(program, fn)
        for node in _walk_skip_nested(fn.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    got = w.lock_of(item.context_expr)
                    if got is not None:
                        direct[id(fn)].add(got.lock)
    acq = {k: set(v) for k, v in direct.items()}
    for _ in range(12):
        changed = False
        for fid, callee_ids in callees.items():
            if fid not in acq:
                acq[fid] = set()
            for cid in callee_ids:
                extra = acq.get(cid, set()) - acq[fid]
                if extra:
                    acq[fid] |= extra
                    changed = True
        if not changed:
            break
    return acq


def _derive_call_edges(program: Program) -> None:
    """Add lock-graph edges for acquisitions made by CALLEES of a
    holding region (the cross-procedure half of RT302)."""
    acq = _transitive_acquires(program)
    for fn, callee, node, held in program.calls:
        if not held:
            continue
        for lock in sorted(acq.get(id(callee), ())):
            for h in held:
                if h.lock == lock:
                    continue
                program.edges.setdefault(
                    (h.lock, lock),
                    (
                        fn.module.path,
                        node.lineno,
                        f"{fn.qual} -> {callee.qual}",
                    ),
                )


# -- blocking propagation (RT303) -------------------------------------


def _blocks_unguarded(program: Program) -> dict[int, tuple]:
    """Per function: the first blocking op it performs while holding
    NO lock of its own (such an op becomes the caller's problem when
    the caller holds one).  Ops already under a lock in the callee are
    reported there, once — not re-reported up the call chain."""
    direct: dict[int, tuple] = {}
    calls_plain: dict[int, list] = {}
    for desc, node, held, fn in program.blocking:
        if not held and not fn.entry_held:
            direct.setdefault(
                id(fn),
                (desc, f"{fn.module.path}:{node.lineno}"),
            )
    for fn, callee, node, held in program.calls:
        if not held and not fn.entry_held:
            calls_plain.setdefault(id(fn), []).append(id(callee))
    out = dict(direct)
    for _ in range(12):
        changed = False
        for fid, callee_ids in calls_plain.items():
            if fid in out:
                continue
            for cid in callee_ids:
                if cid in out:
                    out[fid] = out[cid]
                    changed = True
                    break
        if not changed:
            break
    return out


# -- finding generation -----------------------------------------------


def _mk(rule_cls, path, node, message, extra_lines=()):
    r = rule_cls()
    return (
        Finding(
            rule=r.rule_id,
            severity=r.severity,
            message=message,
            hint=r.hint,
            path=path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
        ),
        tuple(extra_lines),
    )


def _rt301(program: Program):
    findings = []
    groups: dict[tuple, dict] = {}
    for owner, attr, node, held, fn, is_init, constructed in (
        program.writes
    ):
        key = (owner, attr)
        g = groups.setdefault(
            key, {"guarded": [], "unguarded": []}
        )
        eff = frozenset(h.lock for h in held) | fn.entry_held
        if is_init or constructed:
            continue
        if eff:
            g["guarded"].append((eff, fn, node))
        else:
            g["unguarded"].append((node, fn))
    for (owner, attr), g in sorted(
        groups.items(), key=lambda kv: (kv[0][0][1], kv[0][1])
    ):
        if not g["guarded"] or not g["unguarded"]:
            continue
        locks = sorted(set().union(*(e for e, _f, _n in g["guarded"])))
        ex = g["guarded"][0]
        where = f"{ex[1].module.path}:{ex[2].lineno}"
        target = (
            f"{owner[1]}.{attr}"
            if owner[0] == "class"
            else f"global {attr} ({owner[1]})"
        )
        for node, fn in g["unguarded"]:
            findings.append(
                _mk(
                    RT301UnguardedWrite,
                    fn.module.path,
                    node,
                    f"write to {target} without holding "
                    f"{' / '.join(locks)}; other writers hold it "
                    f"(e.g. {where})",
                )
            )
    return findings


def _rt302(program: Program):
    findings = []
    for lock, node, fn in program.self_deadlocks:
        findings.append(
            _mk(
                RT302LockOrder,
                fn.module.path,
                node,
                f"non-reentrant lock {lock} acquired while already "
                "held by this code path (guaranteed self-deadlock); "
                "use RLock only if re-entry is truly intended",
            )
        )
    # cycles in the acquisition-order graph
    graph: dict[str, set] = {}
    for (a, b) in program.edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    for scc in _sccs(graph):
        if len(scc) < 2:
            continue
        cycle = _cycle_path(graph, sorted(scc))
        sites = []
        for a, b in zip(cycle, cycle[1:]):
            path, line, via = program.edges[(a, b)]
            sites.append(f"{a} -> {b} at {path}:{line} ({via})")
        first = program.edges[(cycle[0], cycle[1])]
        anchor = ast.Module(body=[], type_ignores=[])
        anchor.lineno = first[1]
        anchor.col_offset = 0
        findings.append(
            _mk(
                RT302LockOrder,
                first[0],
                anchor,
                "lock-order cycle (potential deadlock): "
                + "; ".join(sites),
            )
        )
    return findings


def _sccs(graph):
    """Iterative Tarjan strongly-connected components."""
    index = {}
    low = {}
    on_stack = set()
    stack = []
    out = []
    counter = [0]
    for root in sorted(graph):
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append(
                        (nxt, iter(sorted(graph.get(nxt, ()))))
                    )
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(comp)
    return out


def _cycle_path(graph, scc_nodes):
    """One concrete cycle through an SCC, closed (first == last)."""
    scc = set(scc_nodes)
    start = scc_nodes[0]
    path = [start]
    seen = {start}
    node = start
    while True:
        nxts = [
            n for n in sorted(graph.get(node, ())) if n in scc
        ]
        nxt = next((n for n in nxts if n == start), None)
        if nxt is None:
            nxt = next((n for n in nxts if n not in seen), None)
        if nxt is None:
            nxt = nxts[0] if nxts else start
        path.append(nxt)
        if nxt == start:
            return path
        if nxt in seen:  # pragma: no cover - defensive closure
            path.append(start)
            return path
        seen.add(nxt)
        node = nxt


def _held_for_report(held, fn):
    """Innermost reportable lock + the `with` line anchor (file_lock
    is exempt from RT303: serializing I/O is its purpose)."""
    for h in reversed(held):
        if h.lock != FILE_LOCK_ID:
            return h.lock, getattr(h.node, "lineno", None)
    if fn.entry_held:
        locks = sorted(
            lk for lk in fn.entry_held if lk != FILE_LOCK_ID
        )
        if locks:
            return locks[0], None
    return None, None


def _rt303(program: Program):
    findings = []
    bu = _blocks_unguarded(program)
    for desc, node, held, fn in program.blocking:
        lock, with_line = _held_for_report(held, fn)
        if lock is None:
            continue
        via = "" if held else " (lock held at every call site)"
        findings.append(
            _mk(
                RT303BlockingUnderLock,
                fn.module.path,
                node,
                f"{desc} while holding {lock}{via} stalls every "
                "thread contending for it",
                extra_lines=(
                    [with_line] if with_line is not None else []
                ),
            )
        )
    for fn, callee, node, held in program.calls:
        if not held:
            continue
        if callee.entry_held:
            continue  # reported inside the callee itself
        blocked = bu.get(id(callee))
        if blocked is None:
            continue
        lock, with_line = _held_for_report(held, fn)
        if lock is None:
            continue
        findings.append(
            _mk(
                RT303BlockingUnderLock,
                fn.module.path,
                node,
                f"call to {callee.qual}() blocks ({blocked[0]} at "
                f"{blocked[1]}) while holding {lock}",
                extra_lines=(
                    [with_line] if with_line is not None else []
                ),
            )
        )
    return findings


def _rt304(program: Program):
    findings = []
    for node, daemon, target_fn, slot, fn in program.threads:
        if daemon is not True and (
            slot is None or slot not in program.joined_slots
        ):
            findings.append(
                _mk(
                    RT304ThreadLifecycle,
                    fn.module.path,
                    node,
                    "non-daemon Thread is never joined: process "
                    "exit will hang on it (pass daemon=True for "
                    "fire-and-forget, or join() it on shutdown)",
                )
            )
        if target_fn is None:
            continue
        for loop in _walk_skip_nested(target_fn.node):
            if not (
                isinstance(loop, ast.While)
                and isinstance(loop.test, ast.Constant)
                and loop.test.value
            ):
                continue
            has_sleep = False
            has_stop = False
            for n in ast.walk(loop):
                if isinstance(n, (ast.Return, ast.Break)):
                    has_stop = True
                if isinstance(n, ast.Call):
                    d = target_fn.module.imports.resolve(n.func)
                    if d == "time.sleep":
                        has_sleep = True
                    if isinstance(n.func, ast.Attribute) and (
                        n.func.attr in ("wait", "is_set")
                    ):
                        has_stop = True
            if has_sleep and not has_stop:
                findings.append(
                    _mk(
                        RT304ThreadLifecycle,
                        target_fn.module.path,
                        loop,
                        f"thread target {target_fn.qual}() loops "
                        "forever on time.sleep with no stop Event "
                        "or exit condition — it can never be shut "
                        "down deterministically",
                    )
                )
    return findings


_SAFE_EXIT_CALLS = {"os._exit", "sys.exit"}


def _handler_safe_stmt(mod, stmt) -> bool:
    if isinstance(stmt, (ast.Pass, ast.Global, ast.Return)):
        return True
    if isinstance(stmt, ast.Assign):
        return isinstance(
            stmt.value, (ast.Constant, ast.Name, ast.Attribute)
        )
    if isinstance(stmt, ast.Expr) and isinstance(
        stmt.value, ast.Call
    ):
        call = stmt.value
        dotted = mod.imports.resolve(call.func)
        if dotted in _SAFE_EXIT_CALLS:
            return True
        return (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "set"
            and not call.args
            and not call.keywords
        )
    return False


def _rt305(program: Program):
    findings = []
    for handler, target, site, mod in program.handlers:
        if isinstance(handler, ast.Lambda):
            body = [ast.Expr(value=handler.body)]
            for s in body:
                ast.copy_location(s, handler.body)
            path, extra = mod.path, [site.lineno]
            check_mod = mod
            anchor_default = handler
        elif target is not None:
            body = target.node.body
            path, extra = target.module.path, [site.lineno]
            check_mod = target.module
            anchor_default = target.node
        else:
            continue
        for stmt in body:
            if _handler_safe_stmt(check_mod, stmt):
                continue
            findings.append(
                _mk(
                    RT305SignalHandler,
                    path,
                    stmt if hasattr(stmt, "lineno") else anchor_default,
                    "signal handler does non-async-signal-safe work "
                    f"(registered at {mod.path}:{site.lineno}); "
                    "handlers may only set an Event/flag or "
                    "os._exit — locks, allocation, and I/O here can "
                    "deadlock or corrupt state",
                    extra_lines=extra if path == mod.path else [],
                )
            )
    return findings


# -- entry point ------------------------------------------------------


def run_concurrency(paths, select=None, built=None) -> list[Finding]:
    """Run the RT3xx whole-program pass; returns filtered findings.
    ``built`` is :func:`build_program`'s result for ``paths`` when the
    caller already has it (``lint`` parses once for all its passes)."""
    program, errors = built if built is not None else build_program(paths)
    raw = (
        _rt301(program)
        + _rt302(program)
        + _rt303(program)
        + _rt304(program)
        + _rt305(program)
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


def _suppressed(mod: ModuleInfo, f: Finding, extra_lines) -> bool:
    """noqa on the finding's line, its decorator lines, or any extra
    anchor (the ``with`` line of the held lock, the ``signal.signal``
    registration line)."""
    if _line_suppresses(mod.lines, f.line, f.rule):
        return True
    for m in (mod.dec_map, mod.span_map):
        rng = m.get(f.line)
        if rng is not None and any(
            _line_suppresses(mod.lines, ln, f.rule) for ln in rng
        ):
            return True
    return any(
        _line_suppresses(mod.lines, ln, f.rule)
        for ln in extra_lines
    )


def lock_graph(paths) -> dict:
    """The derived acquisition-order graph (debug / test surface):
    ``{(src, dst): (path, line, via)}``."""
    program, _errors = build_program(paths)
    return dict(program.edges)
