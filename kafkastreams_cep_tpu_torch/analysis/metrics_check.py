"""metrics: every cep_* metric in code <-> the port's metrics dictionary.

A copy of the JAX package's `analysis/metrics_check.py` over the port's
own dictionary. The JAX package keeps its dictionary in PERF.md (its
``ceplint:`` markers, the first pair in the file); the port's ships with
the code, in `obs/metrics_dictionary.py`, so the gate gives the same
answer in any checkout of the package, one that carries no documents
included. PERF.md repeats it after the JAX section for its readers.

The observability spine is only as trustworthy as its documentation: a
metric emitted but undocumented is invisible to operators; a documented
metric that no code emits is a dashboard that silently reads empty.
This checker extracts every ``cep_*`` name registered through the obs
registry constructors (``.counter(...)``/``.gauge(...)``/
``.histogram(...)``, or a local helper of the same name) and diffs it
both ways against the dictionary section delimited by::

    <!-- ceplint-torch:metrics-dictionary:begin -->
    ...one `cep_name{labels}` per entry...
    <!-- ceplint-torch:metrics-dictionary:end -->

Findings:
    CEP-M01  metric registered in code but absent from the dictionary
    CEP-M02  dictionary entry no code registers (stale doc)
    CEP-M03  the dictionary module or its markers missing
    CEP-M04  PERF.md's copy of the section names other metrics than the
             dictionary (checked wherever PERF.md has the section)

Code-side exceptions carry ``# cep: metric-ok(reason)``; doc-side
findings have no comment channel and go through the baseline.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .core import PACKAGE, Finding, SourceFile

PERF_PATH = "PERF.md"
DICT_PATH = PACKAGE + "/obs/metrics_dictionary.py"
BEGIN = "<!-- ceplint-torch:metrics-dictionary:begin -->"
END = "<!-- ceplint-torch:metrics-dictionary:end -->"
_NAME_RE = re.compile(r"`(cep_[a-z0-9_]+)")
_REG_METHODS = {"counter", "gauge", "histogram"}


def code_metrics(files: Sequence[SourceFile]) -> Dict[str, List[Tuple[str, int]]]:
    """{metric name: [(relpath, line)]} from registry constructor calls."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for src in files:
        for node in ast.walk(src.tree):
            func = node.func if isinstance(node, ast.Call) else None
            if (
                func is not None
                and (
                    (isinstance(func, ast.Attribute) and func.attr in _REG_METHODS)
                    # a local helper named like the constructor it wraps
                    # (`def gauge(name, doc): return r.gauge(...)`)
                    or (isinstance(func, ast.Name) and func.id in _REG_METHODS)
                )
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value.startswith("cep_")
            ):
                out.setdefault(node.args[0].value, []).append(
                    (src.relpath, node.lineno)
                )
    return out


def section_names(path: str) -> Optional[Dict[str, int]]:
    """{name: first line} between the markers of the file at `path`, or
    None when the file or its markers are missing."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().splitlines()
    begin = end = None
    for i, line in enumerate(lines, 1):
        if BEGIN in line and begin is None:
            begin = i
        elif END in line and begin is not None:
            end = i
            break
    if begin is None or end is None:
        return None
    names: Dict[str, int] = {}
    for i in range(begin, end - 1):
        for m in _NAME_RE.finditer(lines[i]):
            names.setdefault(m.group(1), i + 1)
    return names


def doc_metrics(root_dir: str) -> Tuple[Dict[str, int], List[Finding]]:
    """{name: first line} from the dictionary module's section."""
    names = section_names(os.path.join(root_dir, DICT_PATH))
    if names is None:
        return {}, [
            Finding(
                "metrics", "CEP-M03", DICT_PATH, 0,
                f"metrics dictionary or its markers missing ({BEGIN} ... "
                f"{END}) -- the dictionary is the completeness checker's "
                "source of truth",
                context="dictionary-markers-missing",
            )
        ]
    return names, []


def perf_md_drift(root_dir: str, in_doc: Dict[str, int]) -> List[Finding]:
    """CEP-M04 for each name on one side only of PERF.md's copy and the
    dictionary. A PERF.md without the section (or no PERF.md) gives
    none: the documents need not travel with the code."""
    in_perf = section_names(os.path.join(root_dir, PERF_PATH))
    if in_perf is None:
        return []
    out: List[Finding] = []
    for name in sorted(set(in_perf) - set(in_doc)):
        out.append(
            Finding(
                "metrics", "CEP-M04", PERF_PATH, in_perf[name],
                f"PERF.md's port dictionary lists {name}, "
                f"{DICT_PATH} does not",
                context=f"perf-only:{name}",
            )
        )
    for name in sorted(set(in_doc) - set(in_perf)):
        out.append(
            Finding(
                "metrics", "CEP-M04", DICT_PATH, in_doc[name],
                f"{name} is in the dictionary but missing from PERF.md's "
                "copy of it",
                context=f"dictionary-only:{name}",
            )
        )
    return out


def check(files: Sequence[SourceFile], root_dir: str) -> List[Finding]:
    in_code = code_metrics(files)
    in_doc, findings = doc_metrics(root_dir)
    if findings:
        return findings
    findings = perf_md_drift(root_dir, in_doc)
    # Partial runs (a file subset) must not claim doc entries are stale.
    full_scan = any(
        src.relpath == PACKAGE + "/obs/registry.py" for src in files
    )
    for name in sorted(set(in_code) - set(in_doc)):
        path, line = in_code[name][0]
        findings.append(
            Finding(
                "metrics", "CEP-M01", path, line,
                f"metric {name} is registered here but absent from the "
                "metrics dictionary",
                context=f"metric:{name}",
            )
        )
    if full_scan:
        for name in sorted(set(in_doc) - set(in_code)):
            findings.append(
                Finding(
                    "metrics", "CEP-M02", DICT_PATH, in_doc[name],
                    f"dictionary entry {name} is registered by no code "
                    "(stale doc entry)",
                    context=f"metric:{name}",
                )
            )
    return findings
