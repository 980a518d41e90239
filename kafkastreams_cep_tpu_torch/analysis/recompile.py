"""recompile: kernel-build hazards in the builder layer.

The port's counterpart of the JAX package's jit-cache checker. There the
failure class was a jit cache that cannot stay warm across identical
shapes (the JAX soak's churn-recompile RSS leak). Here the program whose
shape is compile-time is the step kernel: ops/codegen.py splices the
query's tables and the capacity into csrc/nfa_step.cu, so each new
(query, config) is an nvcc build (ops/kernel_build.py, keyed by a hash of
the source), and the GC mark and sweep kernels are built once a process.
The same class of bug is a build that re-runs, or a cache that misses,
for a shape already paid for. The static half flags the constructs that
produce it; the runtime half (analysis/kernel_audit.py) replays epochs of
the same shapes and asserts that no build, load or signature count moves.

Findings:
    CEP-R01  a kernel build (`compile_source`, `build_library`,
             `load_library`) or a kernel object (`NfaStep`, `GcMark`,
             `GcSweep`) made inside a for/while loop body -- a build per
             iteration
    CEP-R02  the same inside a hot-path function (zerosync's hot set) --
             a build per advance
    CEP-R03  a build or cache key taken from a mutable or unhashable
             value: a list/dict/set display (or list()/dict()/set()) as
             a module-level cache's key, as `compile_source`'s source or
             stem, or as a `CompileWatch.observe` signature; or a mutable
             default of an `lru_cache`/`cache`-decorated function

No port counterpart:
    R04 (a jitted closure over mutable state): a kernel reads nothing of
        the host after its build -- the query and capacity are text in
        its source, hashed into the build key, and every tensor is a
        launch argument.
    R05 (a capture rebound after the jit wrap): nothing is traced; the
        source is generated and hashed at the build itself.

Builders (``build_*`` functions, the repo convention) are the sanctioned
construction points and exempt from R02 (the runtime audit catches a
builder that churns); so is a build under an ``if <x> is None`` memo
guard. Audited sites carry ``# cep: static-ok(reason)``.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from .core import Finding, SourceFile, dotted_name as _dotted
from .zerosync import hot_functions

#: calls that build, load or construct a kernel (last dotted component).
BUILD_CALLS = {
    "compile_source", "build_library", "load_library", "NfaStep", "GcMark",
    "GcSweep",
}
#: calls whose result is a fresh mutable container.
_MUTABLE_CTORS = {"list", "dict", "set", "bytearray"}
#: (call name, positional indices) whose arguments are build or cache keys.
KEY_ARGS = {"compile_source": (0, 1), "observe": (1,)}
_CACHE_DECORATORS = {"lru_cache", "cache", "functools.lru_cache", "functools.cache"}


def _build_call(node: ast.AST) -> Optional[str]:
    if not isinstance(node, ast.Call):
        return None
    name = (_dotted(node.func) or "").rsplit(".", 1)[-1]
    return name if name in BUILD_CALLS else None


def _mutable(node: ast.AST) -> bool:
    if isinstance(
        node, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
               ast.SetComp)
    ):
        return True
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in _MUTABLE_CTORS
    )


def _module_caches(tree: ast.Module) -> Set[str]:
    """Module-level names bound to a dict (the build and library caches)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, ast.Dict) or (
            isinstance(value, ast.Call) and _dotted(value.func) == "dict"
        ):
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _key_findings(src: SourceFile) -> List[Finding]:
    """CEP-R03 over one module."""
    out: List[Finding] = []
    caches = _module_caches(src.tree)

    def add(node: ast.AST, what: str) -> None:
        out.append(
            Finding(
                "recompile", "CEP-R03", src.relpath, node.lineno,
                f"{what} -- an unhashable or mutable key misses (or raises) "
                "on every call, so the build it guards re-runs",
                context=src.context_line(node.lineno),
            )
        )

    for node in ast.walk(src.tree):
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Name)
            and node.value.id in caches
            and _mutable(node.slice)
        ):
            add(node, f"cache {node.value.id!r} keyed by a mutable value")
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            base = dotted.rsplit(".", 1)[-1]
            if (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in caches
                and base in ("get", "setdefault", "pop")
                and node.args
                and _mutable(node.args[0])
            ):
                add(node, f"cache {node.func.value.id!r} keyed by a mutable value")
            for i in KEY_ARGS.get(base, ()):
                if i < len(node.args) and _mutable(node.args[i]):
                    add(node, f"{base}() given a mutable build key")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cached = any(
                (_dotted(d.func if isinstance(d, ast.Call) else d) or "")
                in _CACHE_DECORATORS
                for d in node.decorator_list
            )
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            if cached and any(_mutable(d) for d in defaults):
                add(node, f"cached builder {node.name!r} has a mutable default")
    return out


class _LoopBuilds(ast.NodeVisitor):
    """CEP-R01: builds inside a loop body (a nested def starts afresh)."""

    def __init__(self, src: SourceFile, out: List[Finding]) -> None:
        self.src = src
        self.out = out
        self.depth = 0
        self.qual: List[str] = []

    def _fn(self, node) -> None:
        self.qual.append(node.name)
        depth, self.depth = self.depth, 0
        self.generic_visit(node)
        self.depth = depth
        self.qual.pop()

    visit_FunctionDef = _fn
    visit_AsyncFunctionDef = _fn

    def visit_ClassDef(self, node) -> None:
        self.qual.append(node.name)
        self.generic_visit(node)
        self.qual.pop()

    def _loop(self, node) -> None:
        self.depth += 1
        self.generic_visit(node)
        self.depth -= 1

    visit_For = _loop
    visit_While = _loop

    def visit_Call(self, node) -> None:
        name = _build_call(node)
        if name is not None and self.depth > 0:
            self.out.append(
                Finding(
                    "recompile", "CEP-R01", self.src.relpath, node.lineno,
                    f"{name}() inside a loop in "
                    f"{'.'.join(self.qual) or '<module>'}: a kernel build "
                    "per iteration",
                    context=self.src.context_line(node.lineno),
                )
            )
        self.generic_visit(node)


def check(files: Sequence[SourceFile], root_dir: str) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        findings.extend(_key_findings(src))
        if not any(_build_call(n) for n in ast.walk(src.tree)):
            continue
        _LoopBuilds(src, findings).visit(src.tree)
        hot_roots, _stale = hot_functions(src)
        for qual, fn in hot_roots.items():
            if qual.rsplit(".", 1)[-1].startswith("build_"):
                continue
            memo_guarded: Set[int] = set()
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.If)
                    and isinstance(node.test, ast.Compare)
                    and any(isinstance(op, ast.Is) for op in node.test.ops)
                    and any(
                        isinstance(c, ast.Constant) and c.value is None
                        for c in node.test.comparators
                    )
                ):
                    memo_guarded.update(id(sub) for sub in ast.walk(node))
            for node in ast.walk(fn):
                name = _build_call(node)
                if name is not None and id(node) not in memo_guarded:
                    findings.append(
                        Finding(
                            "recompile", "CEP-R02", src.relpath, node.lineno,
                            f"{name}() inside hot-path {qual}: a kernel build "
                            "per call on the advance path",
                            context=src.context_line(node.lineno),
                        )
                    )
    return findings
