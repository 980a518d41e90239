"""threads: attributes written from >= 2 thread roots outside a lock.

A copy of the JAX package's `analysis/threads.py`; `EXTRA_ROOTS` names
the port's own framework-driven roots. The engine's concurrency model is deliberately narrow: a main/driver
thread, the introspection plane's serve/clock threads, the soak
scraper, and the single decode worker. Shared mutable state between any
two of them must be written under a lock (or be single-writer by
construction). This checker derives the thread roots statically --
``threading.Thread(target=...)`` constructions, ``.submit(...)`` onto a
``ThreadPoolExecutor``, plus the ``EXTRA_ROOTS`` table for roots that
enter through foreign frameworks (http.server handler threads, the
introspection clock calling registered tick callables) -- then flags
every ``self.attr`` write that (a) is reachable from two distinct roots
or from a multi-instance root, and (b) is not inside a
``with self.<...lock...>`` region.

Findings:
    CEP-T01  unguarded write to an attribute shared across thread roots
    CEP-T02  stale EXTRA_ROOTS row (its pattern matches no method of a
             scanned file -- the table moves with the code)
    CEP-T03  anonymous thread root (Thread without name=, executor
             without thread_name_prefix) -- lock-order reports and
             tracebacks must be attributable

Audited sites carry ``# cep: thread-ok(reason)`` (e.g. a write that is
ordered after ``join()`` by construction). ``__init__`` writes are
initialization-before-spawn and never flagged. The static pass is
paired with the runtime lock-order monitor (analysis/lockmon.py) armed
in the chaos and quick-soak suites.
"""
from __future__ import annotations

import ast
from fnmatch import fnmatch
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import Finding, SourceFile, dotted_name as _dotted

#: repo-relative file -> {method fnmatch pattern: (root name, multi)}.
#: Roots that no static Thread() scan can see: framework-driven entry
#: points. `multi` marks roots whose instances run concurrently with
#: themselves (every ThreadingHTTPServer request gets its own thread).
EXTRA_ROOTS: Dict[str, Dict[str, Tuple[str, bool]]] = {
    "kafkastreams_cep_tpu_torch/obs/http.py": {
        # _Handler.do_GET dispatches plane._routes on per-request threads.
        "IntrospectionServer._route_*": ("http-handler", True),
    },
    "kafkastreams_cep_tpu_torch/streams/driver.py": {
        # serve_http registers maybe_report as an IntrospectionServer
        # tick_fn: it runs on the kct-introspect-clock thread AND on the
        # poll path.
        "LogDriver.maybe_report": ("kct-introspect-clock", False),
        # ... and health / explain / match_exemplars as the plane's
        # health_fn, explain_fn and match_exemplars: /healthz, /explainz
        # and /tracez call them on per-request handler threads.
        "LogDriver.health": ("http-handler", True),
        "LogDriver.explain": ("http-handler", True),
        "LogDriver.match_exemplars": ("http-handler", True),
    },
}

_MAIN = "main"


def _is_lockish(expr: ast.AST) -> bool:
    dotted = _dotted(expr)
    return dotted is not None and "lock" in dotted.lower()


class _Unit:
    """One analyzable body: a method, or a nested def that is a thread
    target (its writes belong to its own root, not its parent's)."""

    def __init__(self, name: str, node: ast.AST, method: str) -> None:
        self.name = name  # display name (method or method.<nested>)
        self.node = node
        self.method = method  # enclosing method name
        self.roots: Set[str] = set()
        #: methods this unit calls via self.m(...)
        self.calls: Set[str] = set()
        #: attr -> [(lineno, guarded, context)]
        self.writes: Dict[str, List[Tuple[int, bool]]] = {}


def _thread_calls(node: ast.AST):
    """Yield (call, kind) for Thread/ThreadPoolExecutor constructions and
    executor .submit() calls anywhere under `node`."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        dotted = _dotted(sub.func) or ""
        base = dotted.rsplit(".", 1)[-1]
        if base == "Thread":
            yield sub, "thread"
        elif base == "ThreadPoolExecutor":
            yield sub, "executor"
        elif (
            isinstance(sub.func, ast.Attribute) and sub.func.attr == "submit"
        ):
            yield sub, "submit"


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _collect_writes(unit: _Unit, skip: Set[ast.AST]) -> None:
    """self.attr write sites with their with-lock guard state."""

    def walk(node: ast.AST, guarded: bool) -> None:
        if node in skip:
            return
        if isinstance(node, ast.With):
            locked = guarded or any(
                _is_lockish(item.context_expr) for item in node.items
            )
            for child in node.body:
                walk(child, locked)
            return
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        def written_attr(t: ast.AST) -> Optional[str]:
            # self.x = ... / self.x += ...       -> x
            # self.x[k] = ... (container entry)  -> x
            # out[self.x[k]] = ...               -> None (self.x only read)
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            ):
                return t.attr
            if isinstance(t, ast.Subscript):
                return written_attr(t.value)
            return None

        for t in targets:
            elts = (
                t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            )
            for elt in elts:
                attr = written_attr(elt)
                if attr is not None:
                    unit.writes.setdefault(attr, []).append(
                        (node.lineno, guarded)
                    )
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    for child in ast.iter_child_nodes(unit.node):
        walk(child, False)


def _analyze_class(
    src: SourceFile, cls: ast.ClassDef
) -> List[Finding]:
    findings: List[Finding] = []
    methods: Dict[str, ast.AST] = {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    units: Dict[str, _Unit] = {
        name: _Unit(name, node, name) for name, node in methods.items()
    }
    #: methods referenced ONLY as thread targets get no implicit main root
    target_only: Set[str] = set()
    #: nested defs promoted to their own unit (skipped in parent walks)
    promoted: Dict[str, Set[ast.AST]] = {m: set() for m in methods}

    def resolve_target(
        expr: ast.AST, method: str
    ) -> Tuple[Optional[str], Optional[ast.AST]]:
        """(unit key, nested node) for a thread-target expression."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in methods
        ):
            return expr.attr, None
        if isinstance(expr, ast.Name):
            for sub in ast.walk(methods[method]):
                if (
                    isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and sub.name == expr.id
                ):
                    return f"{method}.{expr.id}", sub
        return None, None  # external callable (httpd.serve_forever, ...)

    # ------------------------------------------------- roots from Thread()
    for mname, mnode in methods.items():
        for call, kind in _thread_calls(mnode):
            if kind == "executor":
                if _kwarg(call, "thread_name_prefix") is None:
                    findings.append(
                        Finding(
                            "threads", "CEP-T03", src.relpath, call.lineno,
                            "ThreadPoolExecutor without thread_name_prefix: "
                            "anonymous worker threads are unattributable in "
                            "lock-order reports and tracebacks",
                            context=src.context_line(call.lineno),
                        )
                    )
                continue
            if kind == "thread":
                name_kw = _kwarg(call, "name")
                target_kw = _kwarg(call, "target")
                if name_kw is None:
                    findings.append(
                        Finding(
                            "threads", "CEP-T03", src.relpath, call.lineno,
                            "anonymous thread root: Thread(...) without "
                            "name= -- lock-order reports and tracebacks "
                            "must be attributable",
                            context=src.context_line(call.lineno),
                        )
                    )
                if target_kw is None:
                    continue
                root = (
                    name_kw.value
                    if isinstance(name_kw, ast.Constant)
                    and isinstance(name_kw.value, str)
                    else f"thread@{call.lineno}"
                )
                key, nested = resolve_target(target_kw, mname)
                if key is None:
                    continue
                if nested is not None and key not in units:
                    units[key] = _Unit(key, nested, mname)
                    promoted[mname].add(nested)
                units[key].roots.add(root)
                if nested is None:
                    target_only.add(key)
            elif kind == "submit":
                if not call.args:
                    continue
                fn = call.args[0]
                pool = (
                    _dotted(call.func.value)
                    if isinstance(call.func, ast.Attribute)
                    else None
                )
                pool_attr = (
                    pool.split(".", 1)[1] if pool and "." in pool else None
                )
                key, nested = resolve_target(fn, mname)
                if key is None:
                    continue
                if nested is not None and key not in units:
                    units[key] = _Unit(key, nested, mname)
                    promoted[mname].add(nested)
                units[key].roots.add(
                    f"executor:{pool_attr or 'anonymous'}"
                )
                if nested is None:
                    target_only.add(key)

    # --------------------------------------------------------- extra roots
    multi_roots: Set[str] = set()
    for pattern, (root, multi) in EXTRA_ROOTS.get(src.relpath, {}).items():
        for mname in methods:
            if fnmatch(f"{cls.name}.{mname}", pattern):
                units[mname].roots.add(root)
                if multi:
                    multi_roots.add(root)

    # --------------------------------------------- implicit main + callgraph
    # Main enters through the public surface (and dunders); private
    # helpers inherit whatever roots actually call them via the
    # propagation below -- a worker-only private helper must not be
    # painted with main just for existing.
    for mname in methods:
        if mname in target_only:
            continue
        is_public = not mname.startswith("_") or (
            mname.startswith("__") and mname.endswith("__")
        )
        if is_public:
            units[mname].roots.add(_MAIN)
    for key, unit in units.items():
        # Recursive walk with promoted subtrees pruned (ast.walk cannot
        # prune): a call made only inside a promoted worker def belongs
        # to the worker's unit, not the spawning method's -- otherwise
        # the parent's roots leak into worker-only helpers.
        skip = (
            promoted.get(unit.method, set())
            if key == unit.method
            else set()
        )

        def collect(node: ast.AST, unit: _Unit = unit, skip=skip) -> None:
            if node in skip and node is not unit.node:
                return
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if (
                    dotted
                    and dotted.startswith("self.")
                    and dotted.count(".") == 1
                ):
                    callee = dotted.split(".", 1)[1]
                    if callee in methods:
                        unit.calls.add(callee)
            for child in ast.iter_child_nodes(node):
                collect(child, unit, skip)

        collect(unit.node)
    changed = True
    while changed:
        changed = False
        for unit in units.values():
            for callee in unit.calls:
                target = units[callee]
                before = len(target.roots)
                target.roots |= unit.roots
                if len(target.roots) != before:
                    changed = True

    # -------------------------------------------------------------- writes
    for key, unit in units.items():
        _collect_writes(unit, promoted.get(unit.method, set())
                        if key == unit.method else set())

    by_attr: Dict[str, List[Tuple[_Unit, int, bool]]] = {}
    for unit in units.values():
        if unit.method == "__init__" and unit.name == "__init__":
            continue  # initialization happens-before every spawn
        for attr, sites in unit.writes.items():
            for line, guarded in sites:
                by_attr.setdefault(attr, []).append((unit, line, guarded))

    for attr, sites in sorted(by_attr.items()):
        roots: Set[str] = set()
        for unit, _line, _guarded in sites:
            roots |= unit.roots
        shared = len(roots) > 1 or bool(roots & multi_roots)
        if not shared:
            continue
        for unit, line, guarded in sites:
            if guarded:
                continue
            findings.append(
                Finding(
                    "threads", "CEP-T01", src.relpath, line,
                    f"unguarded write to self.{attr} shared across thread "
                    f"roots {{{', '.join(sorted(roots))}}} "
                    f"(in {cls.name}.{unit.name})",
                    context=src.context_line(line),
                )
            )
    return findings


def check(files: Sequence[SourceFile], root_dir: str) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        methods: List[str] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(_analyze_class(src, node))
                methods += [
                    f"{node.name}.{n.name}" for n in node.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                ]
        for pattern in EXTRA_ROOTS.get(src.relpath, {}):
            if not any(fnmatch(m, pattern) for m in methods):
                findings.append(
                    Finding(
                        "threads", "CEP-T02", src.relpath, 0,
                        f"stale EXTRA_ROOTS pattern {pattern!r} matches no "
                        "method -- update analysis/threads.py",
                        context=f"extra-roots:{pattern}",
                    )
                )
    return findings
