"""zerosync: no host read of a tensor on the deferred advance path.

An advance with `decode=False` must dispatch without waiting for the
card: the step kernel, the pend append and the group-flush GC are queued
and the host goes on packing the next batch. One stray `.item()` or
`bool(tensor)` turns that pipeline into lockstep. chip_smoke.py counts
the synchronisations of such advances on the card; this scan pins the
constructs in the source, for every path, on the CPU.

The hot set is `HOT_PATHS` (fnmatch patterns over qualnames, per module of
the package) plus every module-level function of the same module that a
hot function calls by name, transitively; nested functions belong to
their enclosing function. A pattern that matches nothing is a finding, so
the table cannot rot. Inside the hot set these are findings:

  * `.item()`, `.cpu()` and any `synchronize(...)`, whatever the receiver;
  * `.tolist()`, `.numpy()`, `bool()`, `int()`, `float()`,
    `np.asarray()` / `np.array()` and truthiness (`if`, `while`, `assert`,
    `not`, `and`/`or` operands) of a tensor value.

A tensor value is a local dataflow approximation: parameters with the
engine's tensor names, `self.state` / `self.pool`, results of `torch.*`
calls (but `torch.cuda.*`) and of the engine's dispatch attributes, and
anything derived from them by arithmetic, indexing or method calls.
`.shape`, `.dtype`, `.device`, `.ndim` and the methods in `HOST_METHODS`
leave the set. `EXCEPTIONS` lists the functions allowed a host read, each
with its reason.

Run: `python -m kafkastreams_cep_tpu_torch.analysis.zerosync` (exit 1 on
a finding).
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from fnmatch import fnmatch
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

PACKAGE = Path(__file__).resolve().parent.parent

#: Module (relative to the package) -> qualname patterns of the deferred
#: advance path's roots.
HOT_PATHS: Dict[str, Tuple[str, ...]] = {
    "parallel/batched.py": (
        "BatchedDeviceNFA.advance_packed",
        "BatchedDeviceNFA._ledger_append",
        "BatchedDeviceNFA._flush_group",
        "BatchedDeviceNFA._dispatch_pos_probe",
        "BatchedDeviceNFA._occupancy_bound",
        "BatchedDeviceNFA._profile_mark",
        "BatchedDeviceNFA._read_profiles",
    ),
    # The single-key engine's advance with decode=False (its drain is the
    # sync point): the pack, the step, the append and the group flush.
    "ops/device_nfa.py": (
        "DeviceNFA.advance",
        "DeviceNFA._pack",
        "DeviceNFA._ledger_append",
        "DeviceNFA._flush_group",
    ),
    "parallel/key_shard.py": ("build_batched_advance",),
    "ops/engine.py": ("build_append_post", "build_flush_post"),
    "ops/step_kernel.py": ("NfaStep.__call__",),
    "ops/step.py": ("build_plain_step",),
    "ops/gc_kernel.py": ("GcMark.__call__",),
    "ops/gc_sweep.py": ("GcSweep.__call__",),
}

#: (module, qualname) -> why the function may read the host.
EXCEPTIONS: Dict[Tuple[str, str], str] = {
    ("ops/gc_kernel.py", "_walk"): (
        "the plain mark runs only on CPU tensors: GcMark.__call__ launches "
        "the kernel for CUDA tensors"
    ),
}

ARRAY_PARAMS = {
    "state", "pool", "xs", "ys", "st", "window", "page_roots", "marked", "marked_pin", "frontier",
    "pred", "ids", "roots", "w_match", "w_mroot", "group_ys", "group_roots", "leaf",
    "tree", "mask", "vals", "remap_full", "regs", "cols",
}
META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout"}
HOST_METHODS = {
    "size", "dim", "numel", "data_ptr", "element_size", "stride", "is_contiguous",
    "get_device", "type",
}
DISPATCH = ("self._advance", "self._append", "self._flush", "self._plain")
ALWAYS = {"item", "cpu", "synchronize"}
ON_TENSOR = {"tolist", "numpy"}
SCALARIZE = {"bool", "int", "float"}


@dataclass(frozen=True)
class Finding:
    path: str
    function: str
    line: int
    construct: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line} {self.function}: {self.construct}"


def source(relpath: str) -> str:
    return (PACKAGE / relpath).read_text()


def _dotted(node: ast.AST) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Index(ast.NodeVisitor):
    """qualname -> def node, and the module-level function names."""

    def __init__(self) -> None:
        self.functions: Dict[str, ast.AST] = {}
        self.top: Set[str] = set()
        self._stack: List[str] = []

    def _def(self, node) -> None:
        if not self._stack:
            self.top.add(node.name)
        self._stack.append(node.name)
        self.functions[".".join(self._stack)] = node
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _def

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()


def _bound_names(target: ast.AST) -> List[str]:
    """Names an assignment target binds (not those inside `a.b` / `a[i]`)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _bound_names(e)]
    return []


class _Traced:
    """Names bound to tensor values in one function (a fixed point over
    its assignments)."""

    def __init__(self, fn: ast.AST) -> None:
        self.names: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                a = node.args
                for arg in a.posonlyargs + a.args + a.kwonlyargs:
                    if arg.arg in ARRAY_PARAMS:
                        self.names.add(arg.arg)
        binds = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                binds += [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and node.value is not None:
                binds.append((node.target, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                # Iterating a literal tuple of (name, tensor, ...) rows
                # binds its host fields too: only a tensor iterable counts.
                if not isinstance(node.iter, (ast.Tuple, ast.List)):
                    binds.append((node.target, node.iter))
        changed = True
        while changed:
            changed = False
            for target, value in binds:
                if self.tensor(value):
                    for n in _bound_names(target):
                        if n not in self.names:
                            self.names.add(n)
                            changed = True

    def tensor(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in META_ATTRS:
                return False
            if _dotted(node) in ("self.state", "self.pool"):
                return True
            return self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted is not None:
                if dotted.startswith("torch.") and not dotted.startswith("torch.cuda."):
                    return True
                if dotted.startswith(DISPATCH):
                    return True
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in HOST_METHODS | ON_TENSOR:
                    return False
                return self.tensor(node.func.value)
            return False
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.Compare):
            # Identity and membership tests read no tensor.
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.tensor(node.left) or any(self.tensor(c) for c in node.comparators)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return self.tensor(node.body) or self.tensor(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.tensor(e) for e in node.elts)
        return False


def _findings(fn: ast.AST) -> List[Tuple[int, str]]:
    env = _Traced(fn)
    out: List[Tuple[int, str]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                if func.attr in ALWAYS:
                    out.append((node.lineno, f".{func.attr}()"))
                elif func.attr in ON_TENSOR and env.tensor(func.value):
                    out.append((node.lineno, f".{func.attr}() of a tensor"))
                elif (_dotted(func) in ("np.asarray", "np.array", "numpy.asarray")
                      and node.args and env.tensor(node.args[0])):
                    out.append((node.lineno, f"{_dotted(func)}() of a tensor"))
            elif isinstance(func, ast.Name):
                if func.id == "synchronize":
                    out.append((node.lineno, "synchronize()"))
                elif func.id in SCALARIZE and node.args and env.tensor(node.args[0]):
                    out.append((node.lineno, f"{func.id}() of a tensor"))
        tests: List[ast.AST] = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            tests.append(node.test)
        elif isinstance(node, ast.BoolOp):
            tests += node.values
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            tests.append(node.operand)
        out += [(t.lineno, "truthiness of a tensor") for t in tests if env.tensor(t)]
    return out


def _hot(relpath: str, tree: ast.AST) -> Tuple[Dict[str, ast.AST], List[str]]:
    idx = _Index()
    idx.visit(tree)
    hot: Dict[str, ast.AST] = {}
    stale = []
    for pattern in HOT_PATHS.get(relpath, ()):
        hits = [q for q in idx.functions if fnmatch(q, pattern)]
        if not hits:
            stale.append(pattern)
        hot.update((q, idx.functions[q]) for q in hits)
    todo = list(hot.values())
    while todo:
        fn = todo.pop()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in idx.top and node.func.id not in hot):
                hot[node.func.id] = idx.functions[node.func.id]
                todo.append(hot[node.func.id])
    # Nested functions are scanned through their enclosing function.
    roots = {q: n for q, n in hot.items()
             if not any(q != p and q.startswith(p + ".") for p in hot)}
    return roots, stale


def _scan(overrides: Optional[Dict[str, str]] = None):
    overrides = overrides or {}
    findings: List[Finding] = []
    excepted: List[Tuple[str, str]] = []
    for relpath in sorted(HOT_PATHS):
        text = overrides.get(relpath, source(relpath))
        roots, stale = _hot(relpath, ast.parse(text, filename=relpath))
        for pattern in stale:
            findings.append(Finding(relpath, pattern, 0, "HOT_PATHS pattern matches nothing"))
        for qual, fn in sorted(roots.items()):
            found = _findings(fn)
            if (relpath, qual) in EXCEPTIONS:
                if found:
                    excepted.append((relpath, qual))
                continue
            findings += [Finding(relpath, qual, line, what) for line, what in found]
    return findings, excepted


def scan(overrides: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Findings over the package's sources (`overrides` replaces the text
    of some modules, relpath -> source)."""
    return _scan(overrides)[0]


def excepted_hits() -> List[Tuple[str, str]]:
    """The listed exceptions that are hot and do read the host."""
    return _scan()[1]


def main() -> int:
    findings = scan()
    for f in findings:
        print(f)
    print(f"zerosync: {len(findings)} finding(s); exceptions: "
          + ", ".join(f"{p}::{q} ({why})" for (p, q), why in EXCEPTIONS.items()))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
