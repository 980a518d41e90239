"""The port's ceplint core: findings, the pragma grammar, the checker driver.

A copy of the JAX package's `analysis/core.py`; only the roots that
`--all` scans differ (the port package alone).

Pragma grammar (one or more per line, in any comment):

    # cep: <kind>(<reason>)

kinds:
    hot-path            marks the following/containing ``def`` as a
                        zero-sync hot-path function (no reason needed)
    sync-ok(<reason>)   audited host sync on this line (zerosync)
    thread-ok(<reason>) audited unlocked shared write (threads)
    static-ok(<reason>) audited jit-cache hazard (recompile)
    serde-ok(<reason>)  audited serde field exclusion (serde)
    metric-ok(<reason>) audited metric-dictionary exception (metrics)
    trace-ok(<reason>)  audited trace-free control-plane append (tracectx)

(``static-ok`` audits a kernel-build hazard in the port: the recompile
checker there looks at kernel builds, not jit caches.)

A suppression pragma without a reason is itself a finding (CEP-P01): an
audit that does not say *why* the invariant may bend is not an audit.
Findings are fingerprinted line-number-free (checker | code | path |
normalized source line | occurrence index) so unrelated edits do not
churn the committed baseline.
"""
from __future__ import annotations

import ast
import hashlib
import os
import re
import tokenize
from dataclasses import dataclass
from io import StringIO
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "dotted_name",
    "Finding",
    "Pragma",
    "SourceFile",
    "iter_source_files",
    "run_checkers",
    "CHECKERS",
    "repo_root",
    "package_relpath",
]

def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for an Attribute/Name chain, None for anything else --
    the shared AST helper every checker resolves call targets with."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


#: kinds that suppress a checker's findings on their line, mapped to the
#: checker family they may suppress.
SUPPRESSION_KINDS = {
    "sync-ok": "zerosync",
    "thread-ok": "threads",
    "static-ok": "recompile",
    "serde-ok": "serde",
    "metric-ok": "metrics",
    "trace-ok": "tracectx",
}
#: kinds that annotate rather than suppress.
MARKER_KINDS = ("hot-path",)

_PRAGMA_RE = re.compile(
    r"#\s*cep:\s*(?P<kind>[a-z][a-z0-9-]*)\s*(?:\((?P<reason>[^)]*)\))?"
)


@dataclass(frozen=True)
class Pragma:
    kind: str
    reason: Optional[str]
    line: int  # 1-based

    @property
    def has_reason(self) -> bool:
        return bool(self.reason and self.reason.strip())


@dataclass
class Finding:
    checker: str
    code: str  # CEP-XNN
    path: str  # repo-relative, "/"-separated
    line: int  # 1-based; 0 for file-level findings
    message: str
    #: normalized source context (fingerprint input, line-number free)
    context: str = ""
    #: disambiguates identical (code, path, context) findings
    occurrence: int = 0
    suppressed_by: Optional[Pragma] = None
    baselined: bool = False

    def fingerprint(self) -> str:
        raw = "|".join(
            (
                self.checker,
                self.code,
                self.path,
                self.context.strip(),
                str(self.occurrence),
            )
        )
        return hashlib.sha1(raw.encode("utf-8")).hexdigest()[:16]

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.code} [{self.checker}] {self.message}"


class SourceFile:
    """One analyzed file: source text, AST, and per-line pragmas."""

    def __init__(self, path: str, relpath: str, text: str) -> None:
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        #: {line -> [Pragma]} from real comment tokens (never string
        #: literals -- a docstring describing the grammar must not arm it).
        self.pragmas: Dict[int, List[Pragma]] = {}
        for tok in _iter_comments(text):
            for m in _PRAGMA_RE.finditer(tok.string):
                self.pragmas.setdefault(tok.start[0], []).append(
                    Pragma(m.group("kind"), m.group("reason"), tok.start[0])
                )

    # ---------------------------------------------------------------- pragmas
    def pragmas_on(self, line: int, kind: str) -> List[Pragma]:
        return [p for p in self.pragmas.get(line, []) if p.kind == kind]

    def suppression(self, line: int, checker: str) -> Optional[Pragma]:
        """The first well-formed suppression pragma for `checker` on
        `line` (a reasonless pragma does not suppress -- CEP-P01)."""
        for p in self.pragmas.get(line, []):
            if SUPPRESSION_KINDS.get(p.kind) == checker and p.has_reason:
                return p
        return None

    def has_marker(self, line: int, kind: str) -> bool:
        return any(p.kind == kind for p in self.pragmas.get(line, []))

    def context_line(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def _iter_comments(text: str):
    try:
        for tok in tokenize.generate_tokens(StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                yield tok
    except tokenize.TokenError:  # pragma: no cover - ast.parse catches first
        return


def pragma_findings(src: SourceFile) -> List[Finding]:
    """Pragma-grammar findings: reasonless suppressions and unknown kinds."""
    out: List[Finding] = []
    known = set(SUPPRESSION_KINDS) | set(MARKER_KINDS)
    for line, pragmas in sorted(src.pragmas.items()):
        for p in pragmas:
            if p.kind not in known:
                out.append(
                    Finding(
                        "pragma", "CEP-P02", src.relpath, line,
                        f"unknown pragma kind {p.kind!r} "
                        f"(known: {', '.join(sorted(known))})",
                        context=src.context_line(line),
                    )
                )
            elif p.kind in SUPPRESSION_KINDS and not p.has_reason:
                out.append(
                    Finding(
                        "pragma", "CEP-P01", src.relpath, line,
                        f"pragma {p.kind} has no reason -- an audit must "
                        "say why the invariant may bend here",
                        context=src.context_line(line),
                    )
                )
    return out


# ---------------------------------------------------------------------------
# file discovery + driver
# ---------------------------------------------------------------------------
def repo_root() -> str:
    """The repository root (two levels above this package)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


#: the port package's directory name (repo-relative paths start with it).
PACKAGE = "kafkastreams_cep_tpu_torch"
#: roots scanned by ``--all``, relative to the repo root.
DEFAULT_ROOTS = (PACKAGE,)
#: never analyzed: generated, vendored, or non-source trees.
EXCLUDE_PARTS = ("__pycache__", ".jax_cache", "_build", "fixtures")


def package_relpath(relpath: str) -> Optional[str]:
    """`relpath` relative to the port package ("ops/engine.py"), or None
    for a file outside it -- the key of the checkers' binding tables."""
    prefix = PACKAGE + "/"
    return relpath[len(prefix):] if relpath.startswith(prefix) else None


def iter_source_files(
    roots: Iterable[str] = DEFAULT_ROOTS, root_dir: Optional[str] = None
) -> List[SourceFile]:
    root_dir = root_dir or repo_root()
    paths: List[str] = []
    for root in roots:
        full = root if os.path.isabs(root) else os.path.join(root_dir, root)
        if os.path.isfile(full):
            paths.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames if d not in EXCLUDE_PARTS]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    paths.append(os.path.join(dirpath, name))
    out: List[SourceFile] = []
    for path in sorted(set(paths)):
        rel = os.path.relpath(path, root_dir)
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
        out.append(SourceFile(path, rel, text))
    return out


def _number_occurrences(findings: List[Finding]) -> None:
    """Stable occurrence indices for otherwise-identical fingerprints."""
    seen: Dict[Tuple[str, str, str, str], int] = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        key = (f.checker, f.code, f.path, f.context.strip())
        f.occurrence = seen.get(key, 0)
        seen[key] = f.occurrence + 1


def run_checkers(
    files: List[SourceFile],
    checkers: Optional[Iterable[str]] = None,
    root_dir: Optional[str] = None,
) -> List[Finding]:
    """Run the named checkers (all when None) over `files`.

    Returns every finding, with `suppressed_by` set where a well-formed
    pragma covered the line; pragma-grammar findings always run.
    """
    root_dir = root_dir or repo_root()
    names = list(checkers) if checkers is not None else list(CHECKERS)
    findings: List[Finding] = []
    for src in files:
        findings.extend(pragma_findings(src))
    for name in names:
        if name not in CHECKERS:
            raise KeyError(
                f"unknown checker {name!r} (have: {', '.join(CHECKERS)})"
            )
        findings.extend(CHECKERS[name](files, root_dir))
    by_path = {src.relpath: src for src in files}
    for f in findings:
        src = by_path.get(f.path)
        if src is not None and f.line and f.checker in set(
            SUPPRESSION_KINDS.values()
        ):
            f.suppressed_by = src.suppression(f.line, f.checker)
    _number_occurrences(findings)
    findings.sort(key=lambda f: (f.path, f.line, f.code, f.occurrence))
    return findings


def _load_checkers() -> Dict[str, Callable]:
    from . import (
        metrics_check, recompile, serde_check, threads, trace_check, zerosync,
    )

    return {
        "zerosync": zerosync.check,
        "threads": threads.check,
        "recompile": recompile.check,
        "serde": serde_check.check,
        "metrics": metrics_check.check,
        "tracectx": trace_check.check,
    }


class _LazyCheckers(dict):
    """Checker registry resolved on first use (keeps import cycles out
    of the submodules, which all import core)."""

    def _ensure(self) -> None:
        if not super().__len__():
            super().update(_load_checkers())

    def __getitem__(self, key: str) -> Callable:
        self._ensure()
        return super().__getitem__(key)

    def __iter__(self):
        self._ensure()
        return super().__iter__()

    def __contains__(self, key: object) -> bool:
        self._ensure()
        return super().__contains__(key)

    def __len__(self) -> int:
        self._ensure()
        return super().__len__()


CHECKERS: Dict[str, Callable] = _LazyCheckers()
