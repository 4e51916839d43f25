"""Rule-driven AST lint over the port's tree
(``roc_tpu/analysis/ast_lint.py``).

A registry of rules, each scoped to the modules whose invariants it
guards.  Suppression is per line and self-documenting: a trailing
``# roc-lint: ok`` (any rule) or ``# roc-lint: ok=rule-a,rule-b`` on the
flagged line — or the line above it — accepts the finding at the call
site, with the comment text carrying the why.  No torch: the AST level
runs in milliseconds.

The JAX package's rules carry over with the port's paths and torch's
vocabulary; its ``bare-jit`` and ``pallas-interpret`` read constructs
the port does not have, and their invariants become ``unobserved-step``
(every step slot goes through the first-step observer) and
``kernel-fallback`` (a kernel wrapper never answers with its plain
version because the kernel failed).

Adding a rule: subclass :class:`AstRule`, set ``name``/``why``,
implement ``select`` (which repo-relative paths it lints) and ``check``
(yield :class:`Finding`), and append an instance to :data:`RULES`.  Give
every finding a line number and a stable ``key``.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List, Optional

from .findings import Finding

PKG = "roc_tpu_torch/"


def pragma_ok(lines: List[str], lineno: Optional[int],
              rule: str) -> bool:
    """True when the flagged line (or the line above — decorators,
    wrapped calls) carries a ``# roc-lint: ok`` pragma covering
    ``rule``."""
    if lineno is None:
        return False
    for ln in (lineno, lineno - 1):
        if not 1 <= ln <= len(lines):
            continue
        text = lines[ln - 1]
        mark = "roc-lint: ok"
        pos = text.find(mark)
        if pos < 0:
            continue
        rest = text[pos + len(mark):]
        if not rest.startswith("="):
            return True          # bare pragma: every rule
        names = rest[1:].split()[0] if rest[1:].split() else ""
        if rule in [r.strip() for r in names.split(",")]:
            return True
    return False


class AstRule:
    name = "abstract"
    why = ""

    def select(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.AST, relpath: str) -> Iterable[Finding]:
        raise NotImplementedError


def _is_name(node: ast.AST, name: str) -> bool:
    return isinstance(node, ast.Name) and node.id == name


def _is_attr(node: ast.AST, attr: str,
             base: Optional[str] = None) -> bool:
    """``<base>.<attr>`` (any base when ``base`` is None)."""
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and (base is None or _is_name(node.value, base)))


def _ident(node: ast.AST) -> Optional[str]:
    return (node.id if isinstance(node, ast.Name)
            else node.attr if isinstance(node, ast.Attribute) else None)


def _call_name(node: ast.Call) -> Optional[str]:
    return _ident(node.func)


def _own_nodes(body: List[ast.AST]) -> Iterable[ast.AST]:
    """Every node under ``body``, not descending into nested function
    definitions."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class StdoutPrintRule(AstRule):
    """Bare ``print()`` to stdout — stdout belongs to the metrics stream
    (the ``[INFER]`` lines); diagnostics go through
    ``roc_tpu_torch.obs.events.emit`` or ``file=sys.stderr``.  Allowed
    surfaces: places whose stdout IS their product."""

    name = "stdout-print"
    why = ("stdout is a clean metrics stream; route diagnostics through "
           "roc_tpu_torch.obs.events.emit (or file=sys.stderr for "
           "pre-bus error paths)")
    ALLOW_FILES = {PKG + "report.py", PKG + "analysis/__main__.py",
                   # the timeline merger's summary line and the
                   # sentinel's verdict
                   PKG + "obs/timeline.py", PKG + "obs/sentinel.py",
                   # the serve export CLI's one JSON report line
                   PKG + "serve/export.py",
                   # the prewarm CLI's JSON line a config
                   PKG + "prewarm.py",
                   # the dataset converter's summary and training hint,
                   # the JAX script's lines
                   PKG + "convert_dataset.py"}

    def select(self, relpath: str) -> bool:
        return relpath not in self.ALLOW_FILES

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and _is_name(node.func, "print")):
                continue
            if any(kw.arg == "file" for kw in node.keywords):
                continue    # explicit stream (stderr error paths)
            if (len(node.args) == 1
                    and isinstance(node.args[0], ast.Call)
                    and _is_name(node.args[0].func, "format_metrics")):
                continue    # the sanctioned [INFER] metrics line
            yield Finding(self.name, relpath,
                          "bare print() to stdout", line=node.lineno,
                          key=f"print@{node.lineno}")


# the hot paths: the aggregation, kernel and serving code and the
# streamed tier, run once a step or once a request
HOT_PREFIXES = (PKG + "ops/", PKG + "kernels/", PKG + "serve/")
HOT_FILES = {PKG + "core/streaming.py"}


_NOT_TENSOR_ATTRS = {"shape", "size", "ndim", "dtype", "device",
                     "is_cuda", "requires_grad", "numel", "dim",
                     "data_ptr", "element_size", "stride", "nbytes"}


def _tensor_names(func: ast.AST) -> set:
    """Names a function binds to tensors, as far as the AST shows: its
    parameters annotated ``Tensor``, and names assigned a tensor
    expression (:func:`_tensorish`), to a fixpoint."""
    names: set = set()
    args = getattr(func, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and \
                    "Tensor" in ast.unparse(a.annotation):
                names.add(a.arg)
    assigns = [n for n in _own_nodes(getattr(func, "body", []))
               if isinstance(n, (ast.Assign, ast.AnnAssign))]
    while True:
        before = len(names)
        for n in assigns:
            value = n.value
            if value is None:
                continue
            ann = getattr(n, "annotation", None)
            if _tensorish(value, names) or (
                    ann is not None and "Tensor" in ast.unparse(ann)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
        if len(names) == before:
            return names


def _tensorish(expr: ast.AST, names: set) -> bool:
    """A tensor expression: a ``torch.*`` call, a tensor name, or a
    subscript, arithmetic or method call on one (size reads excluded)."""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, names)
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, names) or \
            _tensorish(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.Attribute):
        if expr.attr in _NOT_TENSOR_ATTRS:
            return False
        return _is_name(expr.value, "torch") or \
            _tensorish(expr.value, names)
    if isinstance(expr, ast.Call):
        f = expr.func
        if isinstance(f, ast.Attribute):
            if f.attr in _NOT_TENSOR_ATTRS or f.attr in (
                    "item", "tolist", "numpy"):
                return False
            root = f.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if _is_name(root, "torch"):
                return True
            return _tensorish(f.value, names)
    return False


class HostSyncHotPathRule(AstRule):
    """Device→host syncs in hot-path modules: one ``.item()``,
    ``.cpu()``, ``.numpy()``, ``.tolist()`` of a tensor,
    ``torch.cuda.synchronize`` or ``float(t)``/``int(t)`` of a tensor
    inside the aggregation, kernel, serving or streaming code waits for
    the card every step or request — the stall class the asynchronous
    launch queue exists to avoid.  ``.cpu()``/``.numpy()``/``.item()``
    are flagged on any receiver; ``.tolist()``, ``float()`` and
    ``int()`` when their operand is a tensor as far as the AST shows (a
    ``torch.*`` call, a parameter annotated ``Tensor``, a name assigned
    either, and expressions of those; size reads excluded) — host numpy
    and config scalars are not syncs.  A sync that must stay (the
    result itself, a once-per-eval summary, a host-side export)
    carries a pragma saying why."""

    name = "host-sync-hot-path"
    why = ("hot-path modules must not wait for the card: a host sync "
           "serializes the launch queue")
    ANY_RECEIVER = ("item", "cpu", "numpy")

    def select(self, relpath: str) -> bool:
        return relpath.startswith(HOT_PREFIXES) or relpath in HOT_FILES

    def check(self, tree, relpath):
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes = [(tree, set())] + [(fn, _tensor_names(fn))
                                    for fn in funcs]
        for scope, names in scopes:
            body = scope.body if isinstance(scope, ast.Module) else \
                scope.body
            for node in _own_nodes(body):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if (isinstance(f, ast.Attribute) and not node.args
                        and not node.keywords
                        and (f.attr in self.ANY_RECEIVER
                             or (f.attr == "tolist"
                                 and _tensorish(f.value, names)))):
                    yield Finding(self.name, relpath,
                                  f".{f.attr}() in a hot-path module "
                                  f"(device→host sync)", line=node.lineno,
                                  key=f"{f.attr}@{node.lineno}")
                elif _is_attr(f, "synchronize"):
                    yield Finding(self.name, relpath,
                                  "synchronize() in a hot-path module "
                                  "(waits for the card)",
                                  line=node.lineno,
                                  key=f"synchronize@{node.lineno}")
                elif (isinstance(f, ast.Name) and f.id in ("float", "int")
                        and len(node.args) == 1
                        and _tensorish(node.args[0], names)):
                    yield Finding(self.name, relpath,
                                  f"{f.id}(<tensor>) in a hot-path module "
                                  f"(device→host sync)",
                                  line=node.lineno,
                                  key=f"{f.id}@{node.lineno}")


class SyncH2dInLoopRule(AstRule):
    """Synchronous host→device copies inside a Python loop: a
    ``torch.as_tensor``/``torch.tensor``/``torch.from_numpy`` onto a
    device, a ``.to(<device>)`` or a ``.cuda()`` in a ``for``/``while``
    body puts the copy on the critical path of every iteration — the
    latency-serial pattern the staging pool (``core/streaming.py
    StagingPool``) exists to hide.  Route block staging through the
    pool; genuinely cold loops suppress with ``# roc-lint:
    ok=sync-h2d-in-loop``."""

    name = "sync-h2d-in-loop"
    why = ("a per-iteration host→device copy serializes the transfer "
           "behind compute; stage through core/streaming.StagingPool so "
           "block k+1's copy runs under block k's work")
    LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
                  ast.SetComp, ast.DictComp, ast.GeneratorExp)
    CTORS = {"as_tensor", "tensor", "from_numpy"}

    def select(self, relpath: str) -> bool:
        return (relpath.startswith((PKG + "ops/", PKG + "kernels/"))
                or relpath in HOT_FILES)

    @staticmethod
    def _deviceish(expr: ast.AST) -> bool:
        """A device argument: a name or attribute mentioning ``dev``,
        ``torch.device(...)``, or a ``"cuda..."`` string."""
        if isinstance(expr, ast.Constant):
            return isinstance(expr.value, str) and \
                expr.value.startswith("cuda")
        if isinstance(expr, ast.Call):
            return _call_name(expr) == "device"
        ident = _ident(expr)
        return bool(ident) and "dev" in ident.lower()

    def _what(self, node: ast.Call) -> Optional[str]:
        f = node.func
        name = _call_name(node)
        kws = {kw.arg: kw.value for kw in node.keywords}
        if name in self.CTORS and isinstance(f, ast.Attribute) and \
                _is_name(f.value, "torch"):
            dev = kws.get("device")
            if dev is not None and not (isinstance(dev, ast.Constant)
                                        and dev.value in (None, "cpu")):
                return f"torch.{name}(device=...)"
            return None
        if name == "cuda" and isinstance(f, ast.Attribute):
            return ".cuda()"
        if name == "to" and isinstance(f, ast.Attribute):
            dev = kws.get("device", node.args[0] if node.args else None)
            if dev is not None and self._deviceish(dev):
                return ".to(<device>)"
        return None

    def check(self, tree, relpath):
        seen = set()
        for loop in ast.walk(tree):
            if not isinstance(loop, self.LOOP_NODES):
                continue
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call):
                    continue
                what = self._what(node)
                if what is None:
                    continue
                key = f"{what}@{node.lineno}"
                if key in seen:     # nested loops walk twice
                    continue
                seen.add(key)
                yield Finding(self.name, relpath,
                              f"{what} inside a loop body — "
                              "synchronous H2D on the critical path "
                              "(stage through StagingPool)",
                              line=node.lineno, key=key)


class UnobservedStepRule(AstRule):
    """Every train/eval step slot in the trainer and parallel layers
    goes through ``obs/compile_watch.py ObservedStep`` — a step slot
    bound to anything else runs its first step invisibly: no wall time,
    no FLOP count, no peak-vs-modeled memory check (the invariant the
    JAX package's ``bare-jit`` holds for ``ObservedJit``).  Flags an
    assignment to a step slot (``train_step``/``eval_step``, with or
    without a leading ``_``) whose value is not an ``ObservedStep(...)``
    call, and a ``run_epoch_loop`` call whose step arguments are not
    such slots."""

    name = "unobserved-step"
    why = ("step slots must go through ObservedStep so the first step's "
           "time, FLOPs and peak memory are observed")
    PREFIXES = (PKG + "train/", PKG + "parallel/")
    SLOTS = {"train_step", "eval_step", "_train_step", "_eval_step"}

    def select(self, relpath: str) -> bool:
        return relpath.startswith(self.PREFIXES)

    @staticmethod
    def _observed(expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Call)
                and _call_name(expr) == "ObservedStep")

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    ident = _ident(tgt)
                    if ident in self.SLOTS and not self._observed(
                            node.value):
                        yield Finding(
                            self.name, relpath,
                            f"step slot '{ident}' bound without "
                            f"ObservedStep", line=node.lineno,
                            key=f"slot|{ident}@{node.lineno}")
            elif (isinstance(node, ast.Call)
                    and _call_name(node) == "run_epoch_loop"):
                kws = {kw.arg: kw.value for kw in node.keywords}
                steps = [("do_step", node.args[2] if len(node.args) > 2
                          else kws.get("do_step")),
                         ("do_eval", node.args[3] if len(node.args) > 3
                          else kws.get("do_eval"))]
                for arg, expr in steps:
                    if expr is None or self._observed(expr) or \
                            _ident(expr) in self.SLOTS:
                        continue
                    yield Finding(
                        self.name, relpath,
                        f"run_epoch_loop's {arg} is not an ObservedStep "
                        f"slot", line=node.lineno,
                        key=f"loop|{arg}@{node.lineno}")


class KernelFallbackRule(AstRule):
    """A kernel wrapper takes its plain version only for a CPU tensor,
    never because the kernel failed to build or launch: an ``except``
    in ``kernels/`` whose body calls a ``*_plain`` function, or returns
    a value, answers with something other than the kernel — a
    measurement of the port would then time the plain version and call
    it the kernel's.  (The JAX package's ``pallas-interpret`` holds the
    testability of its kernels; the port's kernels have no interpret
    mode, and their invariant is this one.)"""

    name = "kernel-fallback"
    why = ("a kernel's failure must raise: a wrapper that falls back to "
           "its plain version hides a broken kernel")

    def select(self, relpath: str) -> bool:
        return relpath.startswith(PKG + "kernels/")

    def check(self, tree, relpath):
        for handler in ast.walk(tree):
            if not isinstance(handler, ast.ExceptHandler):
                continue
            for node in _own_nodes(handler.body):
                if isinstance(node, ast.Call) and \
                        (_call_name(node) or "").endswith("_plain"):
                    yield Finding(
                        self.name, relpath,
                        f"except handler calls {_call_name(node)}() — "
                        f"a failed kernel falls back to its plain "
                        f"version", line=node.lineno,
                        key=f"plain@{node.lineno}")
                elif isinstance(node, ast.Return) and not (
                        node.value is None
                        or (isinstance(node.value, ast.Constant)
                            and node.value.value is None)):
                    yield Finding(
                        self.name, relpath,
                        "except handler returns a result after a "
                        "build or launch error", line=node.lineno,
                        key=f"return@{node.lineno}")


class SwallowedExceptionRule(AstRule):
    """Silently swallowed exceptions in the recovery/streaming/
    checkpoint paths: a bare ``except:`` (any body — it eats
    KeyboardInterrupt and SystemExit too), or any handler whose body is
    only ``pass``/``...``.  These are the modules whose job is to
    SURFACE faults — a swallow here converts a diagnosable failure
    (corrupt checkpoint, dead stager, half-written file) into silent
    data loss.  Genuinely benign swallows (best-effort cleanup) suppress
    with ``# roc-lint: ok=swallowed-exception`` and a reason."""

    name = "swallowed-exception"
    why = ("recovery/streaming/checkpoint paths must surface failures: "
           "route them to the resilience event stream or re-raise, or "
           "pragma the line with the why")
    PREFIXES = (PKG + "resilience/",)
    FILES = {PKG + "utils/checkpoint.py", PKG + "utils/resilience.py",
             PKG + "core/streaming.py"}

    def select(self, relpath: str) -> bool:
        return relpath.startswith(self.PREFIXES) or relpath in self.FILES

    @staticmethod
    def _body_is_noop(body) -> bool:
        return all(isinstance(s, ast.Pass)
                   or (isinstance(s, ast.Expr)
                       and isinstance(s.value, ast.Constant)
                       and s.value.value is Ellipsis)
                   for s in body)

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield Finding(self.name, relpath,
                              "bare except: swallows KeyboardInterrupt"
                              "/SystemExit too — name the exception",
                              line=node.lineno,
                              key=f"bare-except@{node.lineno}")
            elif self._body_is_noop(node.body):
                yield Finding(self.name, relpath,
                              "exception handler body is only pass — "
                              "the failure vanishes without a trace",
                              line=node.lineno,
                              key=f"except-pass@{node.lineno}")


class EventClockRule(AstRule):
    """Events go through the bus helper that stamps the clock tuple
    (``obs/events.py emit``): the timeline merger aligns per-process
    streams on the ``(t, mono, host, proc)`` stamps the bus owns, so (a)
    no call site may hand-pass any of those fields to ``emit`` (a
    caller-supplied ``t=``/``proc=`` would mis-lane the record in the
    merged trace), and (b) no module outside the bus may hand-roll an
    event record (a dict literal carrying both ``"cat"`` and ``"msg"``
    keys), which has no clock tuple and falls off the merged time
    axis."""

    name = "event-clock"
    why = ("the bus stamps the (wall, monotonic, host, proc) clock tuple; "
           "hand-stamped or hand-rolled event records break the "
           "cross-process timeline alignment")
    RESERVED = {"t", "mono", "host", "proc"}
    ALLOW_FILES = {PKG + "obs/events.py"}

    def select(self, relpath: str) -> bool:
        return relpath not in self.ALLOW_FILES

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and (
                    _is_name(node.func, "emit")
                    or _is_attr(node.func, "emit")):
                bad = sorted(kw.arg for kw in node.keywords
                             if kw.arg in self.RESERVED)
                if bad:
                    yield Finding(
                        self.name, relpath,
                        f"emit() hand-passes reserved clock field(s) "
                        f"{bad} — the bus stamps the clock tuple",
                        line=node.lineno,
                        key=f"emit-clock@{node.lineno}")
            elif isinstance(node, ast.Dict):
                keys = {k.value for k in node.keys
                        if isinstance(k, ast.Constant)
                        and isinstance(k.value, str)}
                if {"cat", "msg"} <= keys:
                    yield Finding(
                        self.name, relpath,
                        "hand-rolled event record (dict literal with "
                        "'cat' and 'msg' keys) — construct events "
                        "through obs.events.emit so the clock tuple "
                        "is stamped",
                        line=node.lineno,
                        key=f"event-dict@{node.lineno}")


class MetricAdhocRule(AstRule):
    """Serving and training hot paths record metrics through the
    streaming registry (``obs/metrics_registry.py``), not ad-hoc
    instance state: a hand-rolled ``self._n_foo += 1`` counter has no
    window and no snapshot, and an unbounded ``*_ms``/``*_lat`` list
    grows without limit and costs an O(n) sort at every quantile read.
    Flags (a) ``+=``/``-=`` onto a ``_n_*`` attribute and (b)
    ``.append(...)`` onto an attribute ending ``_ms``/``_lat``.
    Sanctioned buffers (the trainer's timeline span laps) carry a
    ``# roc-lint: ok=metric-adhoc`` pragma saying why."""

    name = "metric-adhoc"
    why = ("hot-path counters/latency samples belong in the metrics "
           "registry (windowed, O(1), snapshot-able) — ad-hoc attributes "
           "have no window and unbounded lists leak")
    PREFIXES = (PKG + "serve/",)
    FILES = {PKG + "train/trainer.py"}

    def select(self, relpath: str) -> bool:
        return relpath.startswith(self.PREFIXES) or relpath in self.FILES

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Attribute)
                    and node.target.attr.startswith("_n_")):
                yield Finding(
                    self.name, relpath,
                    f"ad-hoc counter '{node.target.attr} "
                    f"{type(node.op).__name__}=' — use a registry "
                    f"Counter (windowed, O(1) inc)",
                    line=node.lineno,
                    key=f"adhoc-counter@{node.lineno}")
            elif (isinstance(node, ast.Call)
                  and _is_attr(node.func, "append")
                  and isinstance(node.func.value, ast.Attribute)
                  and node.func.value.attr.endswith(("_ms", "_lat"))):
                yield Finding(
                    self.name, relpath,
                    f"ad-hoc latency list "
                    f"'{node.func.value.attr}.append' — use a "
                    f"registry Histogram (log-bucket, bounded, "
                    f"windowed quantiles)",
                    line=node.lineno,
                    key=f"adhoc-latency@{node.lineno}")


class DequantHotPathRule(AstRule):
    """Materializing a full fp32 copy of a quantized serving table inside
    ``serve/``: the point of int8/fp8 tables (``serve/quant.py``) is
    that the ``[V, F]`` buffer never widens — the serve path gathers the
    request's rows and dequantizes those.  An ``.astype(float32)``,
    ``.to(torch.float32)``, ``.float()``, ``asarray(..., dtype=float32)``
    or ``float32(...)`` applied to a table/stage-named array undoes the
    capacity win in one line.  Sanctioned sites — host-side build/load
    paths and rows-only refresh slices — carry a ``# roc-lint:
    ok=dequant-hot-path`` pragma saying why they are not the hot
    path."""

    name = "dequant-hot-path"
    why = ("serve/ must dequantize gathered rows — a full fp32 copy of a "
           "[V, F] table forfeits the quantized capacity win; pragma "
           "host-side build/refresh sites")

    def select(self, relpath: str) -> bool:
        return relpath.startswith(PKG + "serve/")

    @staticmethod
    def _is_f32(node: ast.AST) -> bool:
        return (_is_attr(node, "float32") or _is_name(node, "float32")
                or (isinstance(node, ast.Constant)
                    and node.value == "float32"))

    @staticmethod
    def _tableish(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            ident = _ident(n)
            if ident and ("table" in ident.lower()
                          or "stage" in ident.lower()):
                return True
        return False

    def check(self, tree, relpath):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            kw_f32 = any(kw.arg == "dtype" and self._is_f32(kw.value)
                         for kw in node.keywords)
            if (isinstance(f, ast.Attribute) and f.attr in ("astype", "to")
                    and ((node.args and self._is_f32(node.args[0]))
                         or kw_f32)
                    and self._tableish(f.value)):
                yield Finding(
                    self.name, relpath,
                    f"full fp32 .{f.attr} on a table-shaped array — "
                    f"dequantize gathered rows instead",
                    line=node.lineno, key=f"{f.attr}@{node.lineno}")
            elif (isinstance(f, ast.Attribute) and f.attr == "float"
                    and not node.args and self._tableish(f.value)):
                yield Finding(
                    self.name, relpath,
                    "full fp32 .float() on a table-shaped tensor — "
                    "dequantize gathered rows instead",
                    line=node.lineno, key=f"float@{node.lineno}")
            elif (isinstance(f, ast.Attribute)
                    and f.attr in ("asarray", "as_tensor")
                    and node.args and self._tableish(node.args[0])
                    and kw_f32):
                yield Finding(
                    self.name, relpath,
                    f"{f.attr}(<table>, dtype=float32) materializes a "
                    f"full fp32 table copy",
                    line=node.lineno, key=f"asarray@{node.lineno}")
            elif (self._is_f32(f) and node.args
                    and self._tableish(node.args[0])):
                yield Finding(
                    self.name, relpath,
                    "float32(<table>) cast materializes a full fp32 "
                    "table copy",
                    line=node.lineno, key=f"cast@{node.lineno}")


RULES: List[AstRule] = [StdoutPrintRule(), HostSyncHotPathRule(),
                        SyncH2dInLoopRule(), UnobservedStepRule(),
                        KernelFallbackRule(), SwallowedExceptionRule(),
                        EventClockRule(), MetricAdhocRule(),
                        DequantHotPathRule()]


def run_ast_lint(root: str,
                 select: Optional[List[str]] = None) -> List[Finding]:
    """Run the AST rules over ``<root>/roc_tpu_torch/**/*.py``.
    ``select`` restricts to the named rules (unknown names raise — a
    typo must not silently skip a gate)."""
    rules = RULES
    if select is not None:
        from .concurrency_lint import CONCURRENCY_RULES
        from .protocol_lint import PROTOCOL_RULES
        known = {r.name for r in RULES}
        bad = [s for s in select
               if s not in known and s not in CONCURRENCY_RULES
               and s not in PROTOCOL_RULES]
        if bad:
            raise ValueError(f"unknown lint rule(s): {bad}; "
                             f"AST rules: {sorted(known)}")
        rules = [r for r in RULES if r.name in select]
    findings: List[Finding] = []
    base = pathlib.Path(root)
    for path in sorted(base.glob(PKG + "**/*.py")):
        rel = path.relative_to(base).as_posix()
        applicable = [r for r in rules if r.select(rel)]
        if not applicable:
            continue
        src = path.read_text()
        lines = src.splitlines()
        tree = ast.parse(src, filename=rel)
        for rule in applicable:
            for f in rule.check(tree, rel):
                if not pragma_ok(lines, f.line, rule.name):
                    findings.append(f)
    return findings
