"""Concurrency and signal-safety auditor
(``roc_tpu/analysis/concurrency_lint.py``), over the port's tree.

The port's host side runs threads beside the step loop and the serving
loop: the staging pool's workers (``core/streaming.py``), the heartbeat
watchdog (``obs/heartbeat.py``), the server's dispatcher and the
router's reader and monitor threads (``serve/``), the async checkpoint
saver (``resilience/async_save.py``), the event bus and the metrics
registry's locks (``obs/``), the first-step observer's warm-up thread
(``obs/compile_watch.py``), the kernels' build lock
(``kernels/_build.py``) and the SIGTERM/SIGINT handlers
(``resilience/preempt.py``).  The JAX package's reviews found this bug
class by hand after the fact (a non-signal-reentrant event-bus lock, a
never-delivered ``interrupt_main``, a wake-before-callback race); this
level makes it a ratcheted static gate.

The auditor parses the tree (``roc_tpu_torch/**/*.py`` plus the
repo-root ``chip_smoke.py``) ONCE into a cross-module model of

- **lock objects** — ``threading.Lock/RLock/Condition`` bound to
  instance attributes (``self._lock = threading.Lock()``) or module
  globals (``_BUS_LOCK = threading.Lock()``); ``Event``/``Semaphore``
  are classified but are not locks (no lost-wakeup / ordering
  semantics of their own),
- **thread entry points** — ``threading.Thread(target=...)`` bodies,
  resolved to same-class methods, module functions, or local closures,
- **signal handlers** — ``signal.signal(sig, handler)`` registrations,

and checks seven rules over it (``CONCURRENCY_RULES``).  Call graphs
are walked shallowly (handlers: one level; lock summaries: a small
bounded fixpoint) and attribute calls resolve only when unambiguous
(``self.m`` → the enclosing class; a bare ``obj.m`` only when exactly
one class in the tree defines ``m``) — the auditor prefers missing an
exotic alias to drowning the ratchet in false positives.

Held regions come in two shapes: ``with lock:`` blocks, and explicit
``lock.acquire()`` … ``lock.release()`` pairs — statements between the
pair at the same nesting level are modeled as held, including the
canonical ``acquire(); try: … finally: release()`` idiom (the try body
is the held region).  An ``acquire()`` whose release never appears in
the same statement list holds to the end of the list — conservative,
and exactly what a leaked lock does.

The blocking vocabulary is torch's: device waits
(``torch.cuda.synchronize``, ``.item()``, ``.cpu()``,
``Tensor.to(...)``), ``torch.distributed`` collectives and barriers,
``Future.result`` and ``futures.wait``, beside sleeps, subprocesses,
file I/O and thread joins.  The process gates of the multi-process
rule are ``torch.distributed.get_rank()``, the port's
``process_index()``, ``rank == 0`` tests and the ``RANK`` environment
variable.

Every rule suppresses per line with the standard self-documenting
pragma (``# <why>: roc-lint: ok=<rule>``), findings ride the same
shrink-only baseline ratchet, and the discovered surface (threads /
locks / handlers per module) is exported for ``--json`` and the
``roc_tpu_torch.report`` "concurrency surface" table — the audit
doubles as documentation of the runtime's thread model.
"""

from __future__ import annotations

import ast
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from .ast_lint import pragma_ok
from .findings import Finding
from .protocol_specs import ckpt_artifact_entries, walk_tree

CONCURRENCY_RULES = (
    "signal-unsafe-handler",
    "lock-order-cycle",
    "condvar-wait-no-predicate",
    "unguarded-shared-state",
    "blocking-under-lock",
    "thread-no-shutdown-path",
    "artifact-lock-ownership",
)

# threading constructors that create an *acquirable mutual-exclusion*
# object (these participate in the ordering graph and the held-region
# checks) vs. other sync primitives (classified for the surface table
# and the shutdown-path rule, but not locks)
_LOCK_KINDS = {"Lock": "lock", "RLock": "rlock",
               "Condition": "condition"}
_OTHER_SYNC = {"Event": "event", "Semaphore": "semaphore",
               "BoundedSemaphore": "semaphore", "Barrier": "barrier"}

# mutating container methods: `self.xs.append(...)` in a thread body
# is a write to shared state exactly like `self.x = ...`
_MUTATORS = {"append", "extend", "insert", "add", "remove", "pop",
             "popleft", "appendleft", "clear", "update", "discard",
             "setdefault", "sort", "reverse"}

# callables that block (device waits, collectives, file/process I/O,
# sleeps) — reachable while a lock is held they serialize every other
# holder behind one caller's wait: the stall class the runtime watchdog
# exists to catch, caught here at parse time instead
_BLOCKING_NAMES = {"open"}
_BLOCKING_ATTRS = {"write", "flush", "fsync", "result", "communicate",
                   "emit",
                   # device waits: a stream or the whole card, a read of
                   # a device value to the host, a copy between devices
                   "synchronize", "item", "cpu", "to",
                   # torch.distributed collectives (names no other API
                   # of the tree uses)
                   "all_reduce", "all_gather", "all_gather_object",
                   "all_gather_into_tensor", "reduce_scatter",
                   "reduce_scatter_tensor", "broadcast_object_list",
                   "all_to_all", "all_to_all_single",
                   "monitored_barrier"}
_BLOCKING_QUALIFIED = {("time", "sleep"), ("subprocess", "run"),
                       ("subprocess", "Popen"),
                       ("subprocess", "call"),
                       ("subprocess", "check_call"),
                       ("subprocess", "check_output"),
                       ("os", "fsync"), ("futures", "wait"),
                       # collectives whose names are generic elsewhere
                       ("dist", "barrier"), ("dist", "broadcast"),
                       ("dist", "gather"), ("dist", "scatter"),
                       ("dist", "reduce"), ("dist", "send"),
                       ("dist", "recv")}

# calls sanctioned inside a signal handler: POSIX async-signal-safe
# (or flag-only) primitives the graceful-shutdown path legitimately
# needs — everything else that locks/allocates/does buffered I/O is
# the non-signal-reentrant bus lock's bug class
_HANDLER_SAFE_QUALIFIED = {("signal", "signal"), ("os", "kill"),
                           ("os", "getpid"), ("time", "monotonic"),
                           ("time", "time"), ("time", "perf_counter")}
_HANDLER_SAFE_NAMES = {"int", "float", "str", "bool", "len",
                       "isinstance", "getattr", "KeyboardInterrupt",
                       "RuntimeError", "SystemExit"}


# --------------------------------------------------------------- model

@dataclass(eq=False)
class LockDef:
    """One sync object: a ``self.<name>`` attribute of ``cls`` or
    (``cls=None``) a module-level global."""
    module: str
    cls: Optional[str]
    name: str
    kind: str
    line: int

    @property
    def lock_id(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.module}:{owner}{self.name}"

    @property
    def is_lock(self) -> bool:
        return self.kind in ("lock", "rlock", "condition")


@dataclass(eq=False)
class FuncDef:
    module: str
    cls: Optional[str]
    qualname: str           # Class.method / func / outer.<locals>.f
    node: ast.AST

    @property
    def key(self) -> Tuple[str, str]:
        return (self.module, self.qualname)


@dataclass(eq=False)
class ThreadStart:
    module: str
    cls: Optional[str]              # class whose method starts it
    func: Optional[str]             # qualname of the starting func
    node: ast.Call
    target: Optional[ast.AST]       # the target= expression
    daemon: bool
    name: Optional[str]
    store: Optional[Tuple[str, str]]  # ('attr'|'name', identifier)


@dataclass(eq=False)
class HandlerReg:
    module: str
    node: ast.Call
    handler: Optional[ast.AST]      # the handler expression
    cls: Optional[str]              # class context of the call site


@dataclass(eq=False)
class ModuleModel:
    rel: str
    tree: ast.Module
    lines: List[str]
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)
    # (cls-or-None, name) -> LockDef, every sync object incl. events
    sync: Dict[Tuple[Optional[str], str], LockDef] = \
        field(default_factory=dict)
    funcs: Dict[str, FuncDef] = field(default_factory=dict)
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    signal_aliases: Set[str] = field(default_factory=set)
    threads: List[ThreadStart] = field(default_factory=list)
    handlers: List[HandlerReg] = field(default_factory=list)
    thread_attrs: Set[Tuple[Optional[str], str]] = \
        field(default_factory=set)

    def lock(self, cls: Optional[str], name: str) -> Optional[LockDef]:
        return self.sync.get((cls, name))


class TreeModel:
    """Whole-tree parse: every scanned module's AST plus the derived
    lock/thread/handler indices the rules share."""

    def __init__(self, root: str):
        self.root = root
        self.modules: Dict[str, ModuleModel] = {}
        base = pathlib.Path(root)
        paths = sorted(base.glob("roc_tpu_torch/**/*.py"))
        extra = base / "chip_smoke.py"
        if extra.exists():
            paths.append(extra)
        for path in paths:
            rel = path.relative_to(base).as_posix()
            src = path.read_text()
            self.modules[rel] = _build_module(
                rel, ast.parse(src, filename=rel), src.splitlines())
        # global indices
        self.locks_by_name: Dict[str, List[LockDef]] = {}
        self.methods_by_name: Dict[str, List[FuncDef]] = {}
        for m in self.modules.values():
            for ld in m.sync.values():
                self.locks_by_name.setdefault(ld.name, []).append(ld)
            for f in m.funcs.values():
                if f.cls and f.qualname == f"{f.cls}.{f.node.name}":
                    self.methods_by_name.setdefault(
                        f.node.name, []).append(f)
        self._acq_memo: Dict[Tuple[str, str], Set[str]] = {}
        self._region_memo: Dict[Tuple[str, str],
                                List[Tuple[str, "_HeldRegion"]]] = {}

    # ------------------------------------------------ name resolution

    def resolve_lock(self, mod: ModuleModel, expr: ast.AST,
                     cls: Optional[str]) -> Optional[str]:
        """Lock id for an acquisition expression, ``"?"`` for a
        lock-shaped attribute whose owner is ambiguous (held-region
        checks honor it; the ordering graph skips it), None when the
        expression is not a known lock."""
        if isinstance(expr, ast.Name):
            ld = mod.lock(None, expr.id)
            if ld is not None:
                return ld.lock_id if ld.is_lock else None
            imp = mod.imports.get(expr.id)
            if imp and imp[0] in self.modules:
                ld = self.modules[imp[0]].lock(None, imp[1])
                if ld is not None and ld.is_lock:
                    return ld.lock_id
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and cls is not None:
                ld = mod.lock(cls, expr.attr)
                if ld is not None:
                    return ld.lock_id if ld.is_lock else None
                return None
            cands = [ld for ld in self.locks_by_name.get(expr.attr, [])
                     if ld.is_lock]
            if len(cands) == 1:
                return cands[0].lock_id
            if len(cands) > 1:
                return "?"
        return None

    def resolve_call(self, mod: ModuleModel, call: ast.Call,
                     cls: Optional[str]) -> Optional[FuncDef]:
        """Callee FuncDef for a call node, shallow and conservative:
        same-module functions, ``from``-imported functions, ``self.m``
        methods, and ``obj.m`` only when exactly one class anywhere in
        the tree defines a method ``m``."""
        f = call.func
        if isinstance(f, ast.Name):
            fd = mod.funcs.get(f.id)
            if fd is not None:
                return fd
            imp = mod.imports.get(f.id)
            if imp and imp[0] in self.modules:
                return self.modules[imp[0]].funcs.get(imp[1])
            return None
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and cls is not None:
                return mod.funcs.get(f"{cls}.{f.attr}")
            cands = self.methods_by_name.get(f.attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    # --------------------------------------------- lock-acquire model

    def direct_acquires(self, fd: FuncDef) -> List[Tuple[str, ast.With]]:
        """(lock_id, held-region) for every lock acquisition in
        ``fd`` (``"?"`` kept): with-blocks, plus explicit
        ``acquire()``/``release()`` regions (:meth:`acquire_regions`).
        Both shapes expose a ``.body`` statement list, so every rule
        walking held regions covers them identically."""
        mod = self.modules[fd.module]
        out = []
        for node in _walk_own(fd.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = self.resolve_lock(mod, item.context_expr,
                                            fd.cls)
                    if lid is not None:
                        out.append((lid, node))
        out.extend(self.acquire_regions(fd))
        return out

    def acquire_regions(self, fd: FuncDef
                        ) -> List[Tuple[str, "_HeldRegion"]]:
        """Explicit ``lock.acquire()`` … ``lock.release()`` held
        regions in ``fd``, one per acquire site (memoized): the
        statements between the pair at the same nesting level, or —
        the ``acquire(); try: … finally: release()`` idiom — the try
        body (+ handlers/orelse).  A missing release holds to the end
        of the statement list (that IS the leak)."""
        memo = self._region_memo.get(fd.key)
        if memo is not None:
            return memo
        mod = self.modules[fd.module]
        out: List[Tuple[str, _HeldRegion]] = []
        if not any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "acquire"
                   for n in _walk_own(fd.node)):
            self._region_memo[fd.key] = out     # no acquire: no region
            return out
        for lst in _stmt_lists(fd.node):
            for i, stmt in enumerate(lst):
                expr = _acquire_expr(stmt)
                if expr is None:
                    continue
                lid = self.resolve_lock(mod, expr, fd.cls)
                if lid is None:
                    continue
                nxt = lst[i + 1] if i + 1 < len(lst) else None
                if isinstance(nxt, ast.Try) and any(
                        self._is_release(mod, s, lid, fd.cls)
                        for s in nxt.finalbody):
                    body = (list(nxt.body)
                            + [s for h in nxt.handlers
                               for s in h.body]
                            + list(nxt.orelse))
                else:
                    body = []
                    for s in lst[i + 1:]:
                        if self._is_release(mod, s, lid, fd.cls):
                            break
                        body.append(s)
                out.append((lid, _HeldRegion(body, stmt.lineno)))
        self._region_memo[fd.key] = out
        return out

    def _is_release(self, mod: ModuleModel, stmt: ast.AST, lid: str,
                    cls: Optional[str]) -> bool:
        if not (isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "release"):
            return False
        return self.resolve_lock(mod, stmt.value.func.value,
                                 cls) == lid

    def trans_acquires(self, fd: FuncDef, _depth: int = 0,
                       _stack: Optional[Set[Tuple[str, str]]] = None,
                       _truncated: Optional[List[bool]] = None
                       ) -> Set[str]:
        """Locks ``fd`` may acquire, including through a bounded walk
        of resolvable callees (depth 4 — enough for the tree's
        ``emit -> get_bus -> EventLog.emit`` chain, small enough to
        stay milliseconds).  A result computed under a cycle cut or
        the depth cap is returned but NOT memoized — caching a
        truncated set as final would silently drop real
        acquired-while-holding edges on every later query (the
        mutual-recursion memo-poisoning bug the review fixture
        caught)."""
        memo = self._acq_memo.get(fd.key)
        if memo is not None:
            return memo
        if _stack is None:
            _stack = set()
        if _truncated is None:
            _truncated = [False]
        if fd.key in _stack or _depth > 4:
            _truncated[0] = True
            return set()
        _stack.add(fd.key)
        mod = self.modules[fd.module]
        out: Set[str] = {lid for lid, _ in self.direct_acquires(fd)
                         if lid != "?"}
        for node in _walk_own(fd.node):
            if isinstance(node, ast.Call):
                callee = self.resolve_call(mod, node, fd.cls)
                if callee is not None:
                    out |= self.trans_acquires(callee, _depth + 1,
                                               _stack, _truncated)
        _stack.discard(fd.key)
        if not _truncated[0]:
            self._acq_memo[fd.key] = out
        return out


class _HeldRegion:
    """A synthetic held-region node for an explicit ``acquire()``
    pair: quacks like ``ast.With`` where the rules care (``.body`` is
    the held statement list, ``.lineno`` the acquire site)."""

    __slots__ = ("body", "lineno")

    def __init__(self, body: List[ast.AST], lineno: int):
        self.body = body
        self.lineno = lineno


def _acquire_expr(stmt: ast.AST) -> Optional[ast.AST]:
    """The lock expression of a bare ``<lock>.acquire(...)`` statement
    (an ``if lock.acquire(timeout=...):`` guard is NOT modeled — the
    held region is conditional and the auditor prefers silence to a
    false edge)."""
    if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
        f = stmt.value.func
        if isinstance(f, ast.Attribute) and f.attr == "acquire":
            return f.value
    return None


def _stmt_lists(func_node: ast.AST) -> Iterable[List[ast.AST]]:
    """Every statement list of a function body, WITHOUT descending
    into nested function definitions (their bodies are their own
    entry points, like :func:`_walk_own`)."""
    stack: List[ast.AST] = [func_node]
    while stack:
        node = stack.pop()
        for field in ("body", "orelse", "finalbody"):
            lst = getattr(node, field, None)
            if isinstance(lst, list) and lst \
                    and isinstance(lst[0], ast.stmt):
                yield lst
        for h in getattr(node, "handlers", None) or []:
            if h.body:
                yield h.body
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def _walk_own(func_node: ast.AST) -> List[ast.AST]:
    """Walk a function body WITHOUT descending into nested function
    definitions (a closure is its own entry point, not part of its
    definer's straight-line behavior).  The list is kept on the node:
    every rule walks the same functions."""
    memo = getattr(func_node, "_roc_own", None)
    if memo is not None:
        return memo
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(func_node))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    func_node._roc_own = out
    return out


def _sync_kind(value: ast.AST) -> Optional[str]:
    """'lock'/'rlock'/'condition'/'event'/... when ``value`` is a
    ``threading.X()`` (or bare ``X()``) sync-object constructor."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    name = None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        name = f.attr
    elif isinstance(f, ast.Name):
        name = f.id
    if name in _LOCK_KINDS:
        return _LOCK_KINDS[name]
    if name in _OTHER_SYNC:
        return _OTHER_SYNC[name]
    return None


def _is_thread_ctor(call: ast.Call) -> bool:
    f = call.func
    return ((isinstance(f, ast.Attribute) and f.attr == "Thread"
             and isinstance(f.value, ast.Name)
             and f.value.id == "threading")
            or (isinstance(f, ast.Name) and f.id == "Thread"))


def _const(expr: Optional[ast.AST]) -> Any:
    return expr.value if isinstance(expr, ast.Constant) else None


def _resolve_import_target(rel: str, node: ast.ImportFrom
                           ) -> Optional[str]:
    """Repo-relative ``.py`` path a ``from X import Y`` names (best
    effort; absolute imports of stdlib return a non-existent path the
    caller simply won't find in the model)."""
    parts = rel[:-3].split("/")
    if node.level:
        if node.level > len(parts):
            return None
        base = parts[:-node.level]
    else:
        base = []
    modparts = node.module.split(".") if node.module else []
    target = base + modparts
    if not target:
        return None
    return "/".join(target) + ".py"


def _build_module(rel: str, tree: ast.Module,
                  lines: List[str]) -> ModuleModel:
    m = ModuleModel(rel=rel, tree=tree, lines=lines)
    for node in walk_tree(tree):
        for child in ast.iter_child_nodes(node):
            m.parents[child] = node

    def _cls_of(node: ast.AST) -> Optional[str]:
        cur = node
        while cur in m.parents:
            cur = m.parents[cur]
            if isinstance(cur, ast.ClassDef):
                return cur.name
            if isinstance(cur, ast.Module):
                return None
        return None

    # function registry with qualified names (Class.method for direct
    # methods; dotted <locals> chains for closures)
    def _register(node, prefix: str, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                qn = (f"{prefix}.{child.name}" if prefix
                      else child.name)
                m.funcs[qn] = FuncDef(rel, cls, qn, child)
                _register(child, f"{qn}.<locals>", cls)
            elif isinstance(child, ast.ClassDef):
                _register(child, child.name, child.name)
            elif not isinstance(child, ast.Lambda):
                _register(child, prefix, cls)
    _register(tree, "", None)
    # closures also reachable by bare short name (thread targets are
    # started by name from their definer's scope); plain functions and
    # methods are NOT aliased — a bare call must never accidentally
    # resolve to some class's method
    for qn, fd in list(m.funcs.items()):
        short = qn.rsplit(".", 1)[-1]
        if "<locals>" in qn and short not in m.funcs:
            m.funcs[short] = fd

    # pass 1: imports and sync/thread-attr definitions (order-free
    # facts the second pass depends on)
    for node in walk_tree(tree):
        if isinstance(node, ast.ImportFrom):
            target = _resolve_import_target(rel, node)
            if target:
                for alias in node.names:
                    m.imports.setdefault(alias.asname or alias.name,
                                         (target, alias.name))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "signal":
                    m.signal_aliases.add(alias.asname or "signal")
        elif isinstance(node, ast.Assign):
            kind = _sync_kind(node.value)
            cls = _cls_of(node)
            for tgt in node.targets:
                if kind and isinstance(tgt, ast.Name) and cls is None \
                        and isinstance(m.parents.get(node), ast.Module):
                    m.sync[(None, tgt.id)] = LockDef(
                        rel, None, tgt.id, kind, node.lineno)
                elif isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self" and cls:
                    if kind:
                        m.sync[(cls, tgt.attr)] = LockDef(
                            rel, cls, tgt.attr, kind, node.lineno)
                    if isinstance(node.value, ast.Call) \
                            and _is_thread_ctor(node.value):
                        m.thread_attrs.add((cls, tgt.attr))

    # pass 2: thread starts and signal-handler registrations (these
    # consult the alias/import facts above, so they need their own
    # walk — ast.walk order is not source order)
    for node in walk_tree(tree):
        if isinstance(node, ast.Call):
            if _is_thread_ctor(node):
                kw = {k.arg: k.value for k in node.keywords}
                store = None
                parent = m.parents.get(node)
                if isinstance(parent, ast.Assign) \
                        and len(parent.targets) == 1:
                    t = parent.targets[0]
                    if isinstance(t, ast.Name):
                        store = ("name", t.id)
                    elif isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        store = ("attr", t.attr)
                m.threads.append(ThreadStart(
                    rel, _cls_of(node), _enclosing_func_qualname(m, node),
                    node, kw.get("target"),
                    bool(_const(kw.get("daemon"))),
                    _const(kw.get("name")), store))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "signal" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id in (m.signal_aliases
                                               or {"signal"}) \
                    and len(node.args) == 2:
                m.handlers.append(HandlerReg(rel, node, node.args[1],
                                             _cls_of(node)))
    return m


def _enclosing_func_qualname(m: ModuleModel,
                             node: ast.AST) -> Optional[str]:
    """Registry qualname of the function lexically enclosing ``node``
    (``Class.method``, ``func``, ``outer.<locals>.inner``), or None at
    module scope."""
    chain: List[Tuple[str, str]] = []      # innermost-first
    cur = node
    while cur in m.parents:
        cur = m.parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            chain.append(("f", cur.name))
        elif isinstance(cur, ast.ClassDef):
            chain.append(("c", cur.name))
    while chain and chain[0][0] == "c":    # node sits in a class body
        chain.pop(0)
    if not chain:
        return None
    chain.reverse()
    qn = ""
    prev = None
    for kind, name in chain:
        if not qn:
            qn = name
        elif prev == "f":
            qn = f"{qn}.<locals>.{name}"
        else:
            qn = f"{qn}.{name}"
        prev = kind
    return qn if qn in m.funcs else None


def _enclosing_class(m: ModuleModel, node: ast.AST) -> Optional[str]:
    cur = node
    while cur in m.parents:
        cur = m.parents[cur]
        if isinstance(cur, ast.ClassDef):
            return cur.name
        if isinstance(cur, ast.Module):
            return None
    return None


def _enclosing_while(m: ModuleModel, node: ast.AST) -> bool:
    cur = node
    while cur in m.parents:
        cur = m.parents[cur]
        if isinstance(cur, ast.While):
            return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Module)):
            return False
    return False


def _held_lock(tm: TreeModel, m: ModuleModel, node: ast.AST,
               cls: Optional[str]) -> Optional[str]:
    """Lock id (or ``"?"``) of the innermost enclosing held region —
    a with-block, or an explicit ``acquire()``/``release()`` span —
    else None."""
    seen = {id(node)}
    cur = node
    while cur in m.parents:
        cur = m.parents[cur]
        seen.add(id(cur))
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                lid = tm.resolve_lock(m, item.context_expr, cls)
                if lid is not None:
                    return lid
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # explicit-pair regions of the enclosing function: the
            # node is held if any region statement is on its ancestor
            # chain (statements are the region's roots)
            qn = _enclosing_func_qualname(m, node)
            fd = m.funcs.get(qn) if qn else None
            if fd is not None:
                for lid, region in tm.acquire_regions(fd):
                    if any(id(s) in seen for s in region.body):
                        return lid
            return None
        if isinstance(cur, ast.Module):
            return None
    return None


# ------------------------------------------------- rule: signal safety

def _call_label(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        base = (f.value.id if isinstance(f.value, ast.Name)
                else "<expr>")
        return f"{base}.{f.attr}"
    return "<call>"


def _handler_violations(tm: TreeModel, m: ModuleModel, fd: FuncDef
                        ) -> List[Tuple[int, str]]:
    """(line, why) pairs for non-flag-safe work in one handler body."""
    out: List[Tuple[int, str]] = []
    for node in _walk_own(fd.node):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.append((node.lineno,
                        "import inside a signal handler (can deadlock"
                        " on the interpreter import lock)"))
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                lid = tm.resolve_lock(m, item.context_expr, fd.cls)
                if lid is not None:
                    out.append((node.lineno,
                                f"acquires lock {lid} (not "
                                f"signal-reentrant: the interrupted "
                                f"thread may hold it)"))
        elif isinstance(node, ast.Call):
            label = _call_label(node)
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name):
                q = (f.value.id, f.attr)
                if q in _HANDLER_SAFE_QUALIFIED:
                    continue
                if f.value.id in ("signal", "_signal"):
                    continue
            if isinstance(f, ast.Name) \
                    and f.id in _HANDLER_SAFE_NAMES:
                continue
            if isinstance(f, ast.Attribute) and f.attr == "acquire":
                out.append((node.lineno,
                            f"{label}() acquires a lock in a signal "
                            f"handler"))
            elif isinstance(f, ast.Name) and f.id == "emit" \
                    or isinstance(f, ast.Attribute) and f.attr == "emit":
                out.append((node.lineno,
                            f"{label}() emits on the event bus (bus "
                            f"lock is not signal-reentrant)"))
            elif isinstance(f, ast.Name) and f.id in ("print", "open"):
                out.append((node.lineno,
                            f"{f.id}() does buffered I/O in a signal "
                            f"handler"))
            elif isinstance(f, ast.Attribute) \
                    and f.attr in ("write", "flush"):
                out.append((node.lineno,
                            f"{label}() does I/O in a signal handler"))
            elif isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id in ("np", "numpy", "torch"):
                out.append((node.lineno,
                            f"{label}() allocates/dispatches in a "
                            f"signal handler"))
    return out


def check_signal_handlers(tm: TreeModel) -> List[Finding]:
    """[signal-unsafe-handler] a registered handler's body (plus one
    level of resolvable callees) may only set/read flags: lock
    acquisition, event-bus emits, imports, buffered I/O, and
    numpy/torch allocation are flagged.  ``SIG_DFL``/``SIG_IGN`` and
    unresolvable handler expressions are skipped."""
    findings: List[Finding] = []
    for m in tm.modules.values():
        for reg in m.handlers:
            h = reg.handler
            fd: Optional[FuncDef] = None
            if isinstance(h, ast.Attribute):
                if h.attr in ("SIG_DFL", "SIG_IGN"):
                    continue
                if isinstance(h.value, ast.Name) \
                        and h.value.id == "self" and reg.cls:
                    fd = m.funcs.get(f"{reg.cls}.{h.attr}")
            elif isinstance(h, ast.Name):
                fd = m.funcs.get(h.id)
                if fd is None:
                    imp = m.imports.get(h.id)
                    if imp and imp[0] in tm.modules:
                        fd = tm.modules[imp[0]].funcs.get(imp[1])
            if fd is None:
                continue
            fmod = tm.modules[fd.module]
            # handler body + one level of resolvable callees
            bodies = [(fmod, fd)]
            for node in _walk_own(fd.node):
                if isinstance(node, ast.Call):
                    callee = tm.resolve_call(fmod, node, fd.cls)
                    if callee is not None:
                        bodies.append((tm.modules[callee.module],
                                       callee))
            for bm, bfd in bodies:
                for line, why in _handler_violations(tm, bm, bfd):
                    findings.append(Finding(
                        "signal-unsafe-handler", bm.rel,
                        f"signal handler {fd.qualname} "
                        + (f"(via {bfd.qualname}) " if bfd is not fd
                           else "")
                        + f"must only set/read flags: {why}",
                        line=line,
                        key=f"handler={fd.qualname},"
                            f"via={bfd.qualname}@{line}"))
    return findings


# ---------------------------------------------- rule: lock order graph

def build_lock_graph(tm: TreeModel
                     ) -> Dict[str, Dict[str, Tuple[str, int]]]:
    """acquired-while-holding edges: ``graph[A][B] = (module, line)``
    means some code path acquires B (directly or through a resolvable
    call chain) while holding A."""
    graph: Dict[str, Dict[str, Tuple[str, int]]] = {}
    for m in tm.modules.values():
        for fd in set(m.funcs.values()):
            for lid, wnode in tm.direct_acquires(fd):
                if lid == "?":
                    continue
                inner: Dict[str, int] = {}
                for node in _walk_body(wnode):
                    if isinstance(node, (ast.With, ast.AsyncWith)):
                        for item in node.items:
                            nid = tm.resolve_lock(m, item.context_expr,
                                                  fd.cls)
                            if nid and nid not in ("?", lid):
                                inner.setdefault(nid, node.lineno)
                    elif isinstance(node, ast.Call):
                        f = node.func
                        if isinstance(f, ast.Attribute) \
                                and f.attr == "acquire":
                            # explicit nested acquire: an edge exactly
                            # like a nested with-block
                            nid = tm.resolve_lock(m, f.value, fd.cls)
                            if nid and nid not in ("?", lid):
                                inner.setdefault(nid, node.lineno)
                            continue
                        callee = tm.resolve_call(m, node, fd.cls)
                        if callee is not None:
                            for nid in tm.trans_acquires(callee):
                                if nid != lid:
                                    inner.setdefault(nid, node.lineno)
                for nid, line in inner.items():
                    graph.setdefault(lid, {}).setdefault(
                        nid, (m.rel, line))
    return graph


def _walk_body(wnode: ast.With) -> Iterable[ast.AST]:
    stack = list(wnode.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def check_lock_order(tm: TreeModel) -> List[Finding]:
    """[lock-order-cycle] a cycle in the acquired-while-holding graph
    is a potential deadlock: two threads entering the cycle from
    different edges block each other forever.  One finding per cycle,
    fingerprinted by the sorted lock set (stable across line drift).
    A pragma on any participating acquisition line suppresses the
    cycle (document WHY the ordering is safe — e.g. one of the locks
    is never contended cross-thread)."""
    graph = build_lock_graph(tm)
    findings: List[Finding] = []
    seen: Set[frozenset] = set()
    # iterative DFS cycle detection over a small graph
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, {})):
                if nxt == start:
                    cyc = frozenset(path)
                    if cyc in seen:
                        continue
                    seen.add(cyc)
                    edges = []
                    suppressed = False
                    ring = path + [start]
                    for a, b in zip(ring, ring[1:]):
                        mod, line = graph[a][b]
                        edges.append(f"{a} -> {b} ({mod}:{line})")
                        mm = tm.modules.get(mod)
                        if mm is not None and pragma_ok(
                                mm.lines, line, "lock-order-cycle"):
                            suppressed = True
                    if suppressed:
                        continue
                    mod0, line0 = graph[path[0]][ring[1]]
                    findings.append(Finding(
                        "lock-order-cycle", "concurrency:lock-graph",
                        "lock-ordering cycle (potential deadlock): "
                        + "; ".join(edges),
                        line=line0,
                        key="cycle=" + ",".join(sorted(cyc))))
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))
    return findings


# ------------------------------------- rule: condvar wait w/o predicate

def check_condvar_predicates(tm: TreeModel) -> List[Finding]:
    """[condvar-wait-no-predicate] ``Condition.wait()`` outside a
    ``while``-predicate loop loses wakeups: a notify that fires
    between the caller's predicate check and the wait blocks forever
    (the wake-before-callback race class), and spurious wakeups return
    with the predicate still false.  ``Event.wait`` is level-triggered
    and exempt."""
    findings: List[Finding] = []
    for m in tm.modules.values():
        for fd in set(m.funcs.values()):
            for node in _walk_own(fd.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "wait"):
                    continue
                recv = node.func.value
                ld = None
                if isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self" and fd.cls:
                    ld = m.lock(fd.cls, recv.attr)
                elif isinstance(recv, ast.Name):
                    ld = m.lock(None, recv.id)
                if ld is None or ld.kind != "condition":
                    continue
                if _enclosing_while(m, node):
                    continue
                findings.append(Finding(
                    "condvar-wait-no-predicate", m.rel,
                    f"Condition {ld.lock_id}.wait() outside a "
                    f"while-predicate loop in {fd.qualname} — a "
                    f"notify landing before the wait (or a spurious "
                    f"wakeup) is a lost wakeup; use `while not "
                    f"<predicate>: cv.wait()`",
                    line=node.lineno,
                    key=f"wait@{fd.qualname}"))
    return findings


# --------------------------------------- rule: unguarded shared state

def _thread_body_funcs(tm: TreeModel, m: ModuleModel,
                       ts: ThreadStart) -> List[FuncDef]:
    """The thread target plus the same-class methods it (transitively)
    calls — the code that runs concurrently with public callers."""
    entry: Optional[FuncDef] = None
    t = ts.target
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self" and ts.cls:
        entry = m.funcs.get(f"{ts.cls}.{t.attr}")
    elif isinstance(t, ast.Name):
        if ts.func:
            entry = m.funcs.get(f"{ts.func}.<locals>.{t.id}")
        if entry is None:
            entry = m.funcs.get(t.id)
    if entry is None:
        return []
    out, queue = [], [entry]
    seen = {entry.qualname}
    while queue:
        fd = queue.pop()
        out.append(fd)
        for node in _walk_own(fd.node):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" and ts.cls:
                callee = m.funcs.get(f"{ts.cls}.{node.func.attr}")
                if callee is not None \
                        and callee.qualname not in seen:
                    seen.add(callee.qualname)
                    queue.append(callee)
    return out


def _written_attrs(fds: List[FuncDef]) -> Dict[str, int]:
    """Instance attributes a thread body writes non-trivially.
    Constant assignments (``self.done = True``) are exempt: a
    single-word flag publish is exactly what the flag-based shutdown
    protocol prescribes — it is the read-modify-writes and container
    mutations that race."""
    out: Dict[str, int] = {}

    def _note(attr: str, line: int) -> None:
        out.setdefault(attr, line)

    for fd in fds:
        for node in _walk_own(fd.node):
            if isinstance(node, ast.Assign):
                targets: List[ast.AST] = []
                for t in node.targets:
                    targets.extend(t.elts if isinstance(
                        t, (ast.Tuple, ast.List)) else [t])
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" \
                            and not isinstance(node.value,
                                               ast.Constant):
                        _note(t.attr, node.lineno)
            elif isinstance(node, ast.AugAssign):
                t = node.target
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    _note(t.attr, node.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                recv = node.func.value
                if isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self":
                    _note(recv.attr, node.lineno)
    return out


_PUBLIC_DUNDERS = {"__call__", "__enter__", "__exit__", "__iter__",
                   "__next__", "__len__", "__getitem__"}


def check_unguarded_shared_state(tm: TreeModel) -> List[Finding]:
    """[unguarded-shared-state] instance attributes written inside a
    thread-target body (assignments of non-constants, augmented
    assigns, container mutators) that a PUBLIC method reads or writes
    without holding one of the instance's locks.  Flag publishes
    (constant assigns) are exempt — they are the sanctioned lock-free
    protocol.  Classes with no lock at all still flag: the fix is to
    add one (or pragma the site with why the access is safe)."""
    findings: List[Finding] = []
    for m in tm.modules.values():
        for ts in m.threads:
            if ts.cls is None:
                continue
            body = _thread_body_funcs(tm, m, ts)
            if not body:
                continue
            written = _written_attrs(body)
            if not written:
                continue
            body_names = {fd.qualname for fd in body}
            cls_locks = [ld for (c, _), ld in m.sync.items()
                         if c == ts.cls and ld.is_lock]
            for fd in set(m.funcs.values()):
                if fd.cls != ts.cls or fd.qualname in body_names:
                    continue
                name = fd.node.name
                if name.startswith("_") and name not in _PUBLIC_DUNDERS:
                    continue
                flagged: Set[str] = set()
                for node in _walk_own(fd.node):
                    if not (isinstance(node, ast.Attribute)
                            and isinstance(node.value, ast.Name)
                            and node.value.id == "self"
                            and node.attr in written):
                        continue
                    if node.attr in flagged:
                        continue
                    if _held_lock(tm, m, node, fd.cls) is not None:
                        continue
                    flagged.add(node.attr)
                    lock_hint = (cls_locks[0].lock_id if cls_locks
                                 else f"{ts.cls} has no lock — add "
                                      f"one")
                    findings.append(Finding(
                        "unguarded-shared-state", m.rel,
                        f"{ts.cls}.{name} touches self.{node.attr} "
                        f"without a lock, but the {ts.cls} thread "
                        f"body writes it concurrently "
                        f"(hold {lock_hint})",
                        line=node.lineno,
                        key=f"{ts.cls}.{name}:{node.attr}"))
    return findings


# -------------------------------------------- rule: blocking under lock

def _blocking_label(tm: TreeModel, m: ModuleModel, call: ast.Call,
                    cls: Optional[str],
                    local_threads: Set[str]) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        if f.id in _BLOCKING_NAMES:
            return f"{f.id}()"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    if isinstance(f.value, ast.Name):
        q = (f.value.id, f.attr)
        if q in _BLOCKING_QUALIFIED:
            return f"{q[0]}.{q[1]}()"
    if f.attr == "join":
        # thread joins only — str.join is everywhere and harmless
        recv = f.value
        if isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self" \
                and (cls, recv.attr) in m.thread_attrs:
            return f"self.{recv.attr}.join()"
        if isinstance(recv, ast.Name) and recv.id in local_threads:
            return f"{recv.id}.join()"
        return None
    if f.attr in _BLOCKING_ATTRS:
        return f"{_call_label(call)}()"
    return None


def check_blocking_under_lock(tm: TreeModel) -> List[Finding]:
    """[blocking-under-lock] device round trips, file/process I/O,
    sleeps, ``Future.result()``, thread joins, and event-bus emits
    reachable (directly, or one resolvable call deep) while a lock is
    held — every other would-be holder serializes behind the wait,
    which is the runtime stall class the Heartbeat watchdog exists to
    catch.  Deliberate holds (e.g. a per-line JSONL write whose lock
    IS the line serializer) pragma with the why."""
    findings: List[Finding] = []
    for m in tm.modules.values():
        for fd in set(m.funcs.values()):
            # thread names are FUNCTION-local: another function's
            # `t = Thread(...)` must not make this function's
            # unrelated `t.join()` a thread join
            local_threads = {
                ts.store[1] for ts in m.threads
                if ts.store and ts.store[0] == "name"
                and ts.func == fd.qualname}
            for lid, wnode in tm.direct_acquires(fd):
                for node in _walk_body(wnode):
                    if not isinstance(node, ast.Call):
                        continue
                    label = _blocking_label(tm, m, node, fd.cls,
                                            local_threads)
                    via = ""
                    if label is None:
                        callee = tm.resolve_call(m, node, fd.cls)
                        if callee is None:
                            continue
                        cm = tm.modules[callee.module]
                        for cn in _walk_own(callee.node):
                            if isinstance(cn, ast.Call):
                                inner = _blocking_label(
                                    tm, cm, cn, callee.cls, set())
                                if inner is not None:
                                    label = inner
                                    via = f" via {callee.qualname}"
                                    break
                        if label is None:
                            continue
                    findings.append(Finding(
                        "blocking-under-lock", m.rel,
                        f"{label}{via} while holding {lid} in "
                        f"{fd.qualname} — blocks every other holder "
                        f"(move the slow call outside the lock, or "
                        f"pragma with why the hold is bounded)",
                        line=node.lineno,
                        key=f"{fd.qualname}:{label}{via}"))
    return findings


# ------------------------------------------ rule: thread shutdown path

def check_thread_shutdown(tm: TreeModel) -> List[Finding]:
    """[thread-no-shutdown-path] a started thread needs a bounded stop
    path: either some code joins it (``<store>.join(...)``) or its
    body polls a stop/cancel ``Event`` that some other code sets.
    ``daemon=True`` alone does not count — a daemon thread holding a
    lock shared with atexit/flight-recorder dumps deadlocks the
    teardown it was supposed to never block."""
    findings: List[Finding] = []
    for m in tm.modules.values():
        # events set anywhere in the module: name / self-attr
        set_calls: Set[str] = set()
        for node in walk_tree(m.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "set":
                recv = node.func.value
                if isinstance(recv, ast.Name):
                    set_calls.add(recv.id)
                elif isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self":
                    set_calls.add(recv.attr)
        # a join on a LOCAL name only covers threads stored to that
        # name in the SAME function (two functions reusing `t` must
        # not vouch for each other); self-attr joins cover the SAME
        # class — close()/joining another method is the normal shape,
        # but one class's join must not vouch for another class's
        # same-named thread attr
        joined: Set[Tuple[str, str, Optional[str]]] = set()
        for node in walk_tree(m.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                recv = node.func.value
                if isinstance(recv, ast.Name):
                    joined.add(("name", recv.id,
                                _enclosing_func_qualname(m, node)))
                elif isinstance(recv, ast.Attribute) \
                        and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self":
                    joined.add(("attr", recv.attr,
                                _enclosing_class(m, node)))
        for ts in m.threads:
            if ts.store is not None:
                kind, ident = ts.store
                scope = ts.func if kind == "name" else ts.cls
                if (kind, ident, scope) in joined:
                    continue
            body = _thread_body_funcs(tm, m, ts)
            polls_stop = False
            for fd in body:
                for node in _walk_own(fd.node):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in ("is_set", "wait"):
                        recv = node.func.value
                        nm = None
                        if isinstance(recv, ast.Name):
                            nm = recv.id
                        elif isinstance(recv, ast.Attribute) \
                                and isinstance(recv.value, ast.Name) \
                                and recv.value.id == "self":
                            nm = recv.attr
                        if nm is not None and nm in set_calls:
                            polls_stop = True
            if polls_stop:
                continue
            tname = (_const_target_name(ts) or "<unresolved>")
            findings.append(Finding(
                "thread-no-shutdown-path", m.rel,
                f"thread target {tname} started"
                + (f" in {ts.func}" if ts.func else "")
                + " with no bounded stop path: nothing joins it and "
                  "its body polls no stop Event (daemon= alone does "
                  "not count for threads sharing locks with "
                  "atexit/flight-recorder paths)",
                line=ts.node.lineno,
                key=f"thread={ts.func or m.rel}:{tname}"))
    return findings


def _const_target_name(ts: ThreadStart) -> Optional[str]:
    t = ts.target
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute):
        return ast.unparse(t) if hasattr(ast, "unparse") else t.attr
    return None


# ----------------------------------- rule: artifact lock ownership

# On-disk artifacts shared ACROSS PROCESSES (the multi-process half of
# this level): the checkpoint-rotation prefix (N training ranks, one
# rotation directory), whose ONE sanctioned ownership protocol is the
# shared-rotation handshake — rank 0 writes and prunes, everyone else
# returns (the rank gates of utils/checkpoint.py and
# resilience/recovery.py) — or a per-process prefix.  The JAX package's
# compile-cache and warm-state artifacts have no counterpart here.
#
# The rule: a rotation WRITE site (``<rotation>.save(...)``,
# ``checkpoint_trainer(...)``, ``save_checkpoint(...)``) with no
# process-ownership evidence anywhere on its call chain is a finding
# — two training processes pruning one rotation prefix unhandshaked
# corrupt each other's keep-window exactly like two threads on one
# unguarded list.

_ROTATION_CTOR = "CheckpointRotation"
_ROTATION_WRITERS = {"checkpoint_trainer", "save_checkpoint"}
_PER_PROCESS_PATH_MARKERS = ("getpid", "process_index", "pid", "rank")
# the process identity: torch.distributed's rank and world size, the
# port's obs/events.py process_index(), the JAX package's names
_GATE_ATTRS = {"process_index", "process_count", "get_rank",
               "get_world_size"}
# the launcher's identity variable (os.environ["RANK"])
_GATE_ENV = {"RANK"}
# checkpoint-v3 two-phase-commit vocabulary: lives in protocol_specs
# (the protocol level owns the commit-ORDER rule, ``ckpt-commit-order``);
# the artifact surface below inventories the same call sites through the
# shared helper.


def _is_rank_zero_test(node: ast.AST) -> bool:
    """``<...rank> == 0`` / ``!= 0`` (either side): the rank gate."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1
            and isinstance(node.ops[0], (ast.Eq, ast.NotEq))):
        return False
    sides = [node.left, node.comparators[0]]
    names = [(x.id if isinstance(x, ast.Name)
              else x.attr if isinstance(x, ast.Attribute) else "")
             for x in sides]
    zero = [isinstance(x, ast.Constant) and x.value == 0 for x in sides]
    return ((names[0].endswith("rank") and zero[1])
            or (names[1].endswith("rank") and zero[0]))


def _refs_process_gate(tm: TreeModel, fd: FuncDef, _depth: int = 0,
                       _stack: Optional[Set[Tuple[str, str]]] = None
                       ) -> bool:
    """True when ``fd`` (or a resolvable callee within depth 4)
    consults the process identity — the shared-rotation handshake's
    signature."""
    if _stack is None:
        _stack = set()
    if fd.key in _stack or _depth > 4:
        return False
    _stack.add(fd.key)
    mod = tm.modules[fd.module]
    try:
        for node in _walk_own(fd.node):
            if isinstance(node, ast.Attribute) \
                    and node.attr in _GATE_ATTRS:
                return True
            if isinstance(node, ast.Name) and node.id in _GATE_ATTRS:
                return True
            if isinstance(node, ast.Constant) and node.value in _GATE_ENV:
                return True
            if _is_rank_zero_test(node):
                return True
            if isinstance(node, ast.Call):
                callee = tm.resolve_call(mod, node, fd.cls)
                if callee is not None and _refs_process_gate(
                        tm, callee, _depth + 1, _stack):
                    return True
        return False
    finally:
        _stack.discard(fd.key)


def _rotation_assigns(nodes: Iterable[ast.AST],
                      m: Optional[ModuleModel] = None
                      ) -> Dict[Tuple[str, str], str]:
    """``('name'|'attr', identifier) -> prefix source`` for every
    ``X = CheckpointRotation(<prefix>, ...)`` assignment among
    ``nodes``.  With ``m``, self-attr identifiers are qualified by
    their enclosing CLASS (``Cls.attr``) — two classes reusing one
    attribute name must never vouch for each other's prefixes."""
    out: Dict[Tuple[str, str], str] = {}
    for node in nodes:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        f = node.value.func
        ctor = (f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None)
        if ctor != _ROTATION_CTOR:
            continue
        prefix = ""
        if node.value.args:
            try:
                prefix = ast.unparse(node.value.args[0])
            except Exception:  # noqa: BLE001 - py<3.9 has no unparse
                prefix = "?"
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out[("name", tgt.id)] = prefix
            elif isinstance(tgt, ast.Attribute) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "self":
                cls = _enclosing_class(m, node) if m else None
                out[("attr", f"{cls or ''}.{tgt.attr}")] = prefix
    return out


def _module_rotation_bindings(m: ModuleModel
                              ) -> Dict[Tuple[str, str], str]:
    """The module-wide rotation bindings: self-attr bindings
    (class-scoped keys) plus module-LEVEL name bindings.  Name
    assignments inside functions are deliberately excluded — their
    values must never shadow a module-level binding of the same name
    (a function-local per-process prefix would otherwise vouch for
    an unrelated module-level shared-prefix writer)."""
    out = {k: v
           for k, v in _rotation_assigns(walk_tree(m.tree), m).items()
           if k[0] == "attr"}
    out.update(
        {k: v for k, v in _rotation_assigns(
            (n for n in ast.iter_child_nodes(m.tree)), m).items()
         if k[0] == "name"})
    return out


def _rotation_bindings(m: ModuleModel,
                       fd: Optional[FuncDef] = None,
                       base: Optional[Dict[Tuple[str, str], str]]
                       = None) -> Dict[Tuple[str, str], str]:
    """Rotation bindings visible to ``fd``: name-bindings are
    FUNCTION-scoped (two functions reusing ``rot`` must not vouch
    for each other's prefixes — the per-process exemption of one
    must never leak onto the other), self-attr bindings are
    class-scoped, module-level names module-wide.  ``base`` lets a
    caller hoist :func:`_module_rotation_bindings` out of a per-
    function loop."""
    out = dict(base if base is not None
               else _module_rotation_bindings(m))
    if fd is not None:
        out.update(_rotation_assigns(
            (n for n in _walk_own(fd.node)
             if isinstance(n, ast.Assign)), m))
    return out


def _rotation_save_gated(tm: TreeModel) -> bool:
    """Whether the tree's own ``CheckpointRotation.save`` carries the
    handshake (transitively) — then every ``<rotation>.save(...)``
    call site inherits the evidence.  False when the class is not in
    the tree (fixture trees importing it from elsewhere must carry
    their own gate)."""
    for fd in tm.methods_by_name.get("save", []):
        if fd.cls == _ROTATION_CTOR and _refs_process_gate(tm, fd):
            return True
    return False


def check_artifact_lock_ownership(tm: TreeModel) -> List[Finding]:
    """[artifact-lock-ownership] see the section comment above.
    Ownership evidence, any one of which clears a write site: the
    process-identity gate on the enclosing function or anywhere down
    the written-through call chain; a per-process prefix
    (pid/rank/process_index in the path expression); or the standard
    pragma documenting why single-writer is guaranteed."""
    findings: List[Finding] = []
    rot_gated = _rotation_save_gated(tm)
    for m in tm.modules.values():
        base = _module_rotation_bindings(m)
        for fd in set(m.funcs.values()):
            bindings = _rotation_bindings(m, fd, base=base)
            for node in _walk_own(fd.node):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                label = prefix = None
                chain_gated = False
                if isinstance(f, ast.Attribute) and f.attr == "save":
                    recv = f.value
                    key = None
                    if isinstance(recv, ast.Name):
                        key = ("name", recv.id)
                        # convention fallback: a parameter named
                        # rotation* IS a CheckpointRotation (the
                        # train_with_recovery shape)
                        if key not in bindings \
                                and not recv.id.startswith("rotation"):
                            key = None
                    elif isinstance(recv, ast.Attribute) \
                            and isinstance(recv.value, ast.Name) \
                            and recv.value.id == "self":
                        key = ("attr", f"{fd.cls or ''}.{recv.attr}")
                        if key not in bindings:
                            key = None
                    if key is None:
                        continue
                    label = f"{key[1]}.save()"
                    prefix = bindings.get(key, "")
                    chain_gated = rot_gated
                elif isinstance(f, ast.Name) \
                        and f.id in _ROTATION_WRITERS:
                    label = f"{f.id}()"
                    callee = tm.resolve_call(m, node, fd.cls)
                    chain_gated = (callee is not None
                                   and _refs_process_gate(tm, callee))
                else:
                    continue
                if chain_gated or _refs_process_gate(tm, fd):
                    continue
                if prefix and any(mk in prefix for mk in
                                  _PER_PROCESS_PATH_MARKERS):
                    continue
                findings.append(Finding(
                    "artifact-lock-ownership", m.rel,
                    f"{label} in {fd.qualname} writes a checkpoint-"
                    f"rotation prefix"
                    + (f" ({prefix})" if prefix else "")
                    + " with no process-ownership evidence: under "
                      "multi-process SPMD every process would write "
                      "and prune the same rotation — gate on "
                      "the rank (the shared-rotation "
                      "handshake) or use a per-process prefix",
                    line=node.lineno,
                    key=f"writer|{fd.qualname}|{label}"))
    return findings


def _call_name(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def artifact_surface(tm: TreeModel) -> List[Dict[str, Any]]:
    """Per-module artifact-lock inventory for the surface table:
    which process-shared on-disk artifacts each module touches
    (rotation prefixes with their ownership evidence, checkpoint
    shard and manifest writes)."""
    rot_gated = _rotation_save_gated(tm)
    out: List[Dict[str, Any]] = []
    for rel in sorted(tm.modules):
        m = tm.modules[rel]
        arts: List[Dict[str, Any]] = []
        for (kind, name), prefix in sorted(
                _rotation_assigns(walk_tree(m.tree), m).items()):
            arts.append({"kind": "rotation",
                         "name": name.lstrip("."),
                         "path": prefix,
                         "owner": ("proc0-gate" if rot_gated
                                   else "unknown")})
        # checkpoint-v3 shard/manifest call sites: the writer
        # vocabulary and inventory live in protocol_specs (the one
        # source of truth)
        arts.extend(ckpt_artifact_entries(m.tree))
        if arts:
            out.append({"module": rel, "artifacts": arts})
    return out


# ------------------------------------------------- surface + entrypoint

def concurrency_surface(tm: TreeModel) -> Dict[str, Any]:
    """The discovered thread model, per module — threads (target,
    daemon, stop path), locks (owner.attr, kind), handlers — the
    payload behind ``--json``'s ``concurrency_surface`` and the
    ``roc_tpu_torch.report`` table.  The audit doubles as documentation:
    if a thread or lock is missing here, the auditor (and therefore
    every rule above) cannot see it."""
    mods: List[Dict[str, Any]] = []
    for rel in sorted(tm.modules):
        m = tm.modules[rel]
        if not (m.threads or m.sync or m.handlers):
            continue
        threads = []
        for ts in m.threads:
            threads.append({
                "target": _const_target_name(ts),
                "in": ts.func, "daemon": ts.daemon,
                "name": ts.name, "line": ts.node.lineno})
        locks = [{"name": (f"{c}.{n}" if c else n), "kind": ld.kind,
                  "line": ld.line}
                 for (c, n), ld in sorted(
                     m.sync.items(),
                     key=lambda kv: (kv[0][0] or "", kv[0][1]))]
        handlers = []
        for reg in m.handlers:
            h = reg.handler
            label = None
            if isinstance(h, ast.Attribute):
                if h.attr in ("SIG_DFL", "SIG_IGN"):
                    continue    # disposition reset, not a handler
                label = h.attr
            elif isinstance(h, ast.Name):
                label = h.id
            handlers.append({"handler": label,
                             "line": reg.node.lineno})
        mods.append({"module": rel, "threads": threads,
                     "locks": locks, "handlers": handlers})
    artifacts = artifact_surface(tm)
    return {
        "modules": mods,
        "artifacts": artifacts,
        "totals": {
            "modules": len(mods),
            "threads": sum(len(x["threads"]) for x in mods),
            "locks": sum(len(x["locks"]) for x in mods),
            "handlers": sum(len(x["handlers"]) for x in mods),
            "artifacts": sum(len(x["artifacts"])
                             for x in artifacts)}}


_CHECKS = {
    "signal-unsafe-handler": check_signal_handlers,
    "lock-order-cycle": check_lock_order,
    "condvar-wait-no-predicate": check_condvar_predicates,
    "unguarded-shared-state": check_unguarded_shared_state,
    "blocking-under-lock": check_blocking_under_lock,
    "thread-no-shutdown-path": check_thread_shutdown,
    "artifact-lock-ownership": check_artifact_lock_ownership,
}


def run_concurrency_lint(root: str,
                         select: Optional[List[str]] = None,
                         tree_model: Optional[TreeModel] = None
                         ) -> List[Finding]:
    """Run the selected (default: all) concurrency rules over
    ``root``.  Pure AST — no torch, milliseconds.  Per-line pragma
    suppression applies to every finding with a line; the
    cross-module ``lock-order-cycle`` rule checks its pragmas at each
    participating acquisition site itself."""
    tm = tree_model if tree_model is not None else TreeModel(root)
    findings: List[Finding] = []
    for name, check in _CHECKS.items():
        if select is not None and name not in select:
            continue
        for f in check(tm):
            m = tm.modules.get(f.unit)
            if m is not None and pragma_ok(m.lines, f.line, f.rule):
                continue
            findings.append(f)
    return findings


def audit_concurrency(root: str,
                      select: Optional[List[str]] = None,
                      extras: Optional[Dict[str, Any]] = None,
                      tree_model: Optional[TreeModel] = None
                      ) -> List[Finding]:
    """Level-six entry point for the driver: run the rules, stash the
    surface under ``extras['concurrency']``, and emit the surface as
    an ``analysis`` event (kind=``concurrency_surface``) so a run
    artifact documents its own thread model and
    ``python -m roc_tpu_torch.report`` can render the table from the event
    stream alone."""
    from ..obs.events import emit
    tm = tree_model if tree_model is not None else TreeModel(root)
    findings = run_concurrency_lint(root, select=select,
                                    tree_model=tm)
    surface = concurrency_surface(tm)
    if extras is not None:
        extras["concurrency"] = surface
    t = surface["totals"]
    emit("analysis",
         f"concurrency surface: {t['threads']} thread(s), "
         f"{t['locks']} sync object(s), {t['handlers']} signal "
         f"handler(s) across {t['modules']} module(s)",
         console=False, kind="concurrency_surface",
         modules=surface["modules"], totals=t)
    return findings
