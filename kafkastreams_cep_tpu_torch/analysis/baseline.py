"""Baseline semantics: the committed ledger of accepted findings.

A copy of the JAX package's `analysis/baseline.py` over the port's own
file: ``ceplint_torch.baseline.json`` at the repo root is the one escape
hatch that is not a source pragma (doc-side findings have no comment
channel, and bulk-adopting the linter on a brownfield tree needs a
ratchet). The contract keeps it honest:

- every entry must carry a nonempty ``note`` (CEP-B02 otherwise) --
  like pragmas, a baseline without a why is not an audit;
- an entry whose fingerprint matches no current finding is *stale*
  (CEP-B01): the finding was fixed, so the entry must go -- baselines
  only ever shrink by hand or via ``--update-baseline``;
- fingerprints are line-number-free (analysis/core.Finding), so pure
  movement does not churn the file.

``apply_baseline`` marks matched findings ``baselined`` (excluded from
the exit code); ``update`` rewrites the file to exactly the current
unsuppressed findings, preserving notes of surviving entries and
stamping new ones ``TODO: annotate``(which CEP-B02 then flags -- adding
to the baseline is two steps by design: record, then justify).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Set, Tuple

from .core import Finding

BASELINE_NAME = "ceplint_torch.baseline.json"
_TODO = "TODO: annotate"


def default_path(root_dir: str) -> str:
    return os.path.join(root_dir, BASELINE_NAME)


def load(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("findings", [])
    if not isinstance(entries, list):
        raise ValueError(f"{path}: 'findings' must be a list")
    return entries


def save(path: str, entries: List[Dict[str, Any]]) -> None:
    doc = {
        "version": 1,
        "tool": "ceplint",
        "findings": sorted(
            entries, key=lambda e: (e.get("path", ""), e.get("code", ""))
        ),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def entry_in_scope(
    entry: Dict[str, Any],
    scanned_paths: Optional[Set[str]] = None,
    checkers: Optional[Set[str]] = None,
) -> bool:
    """Could this run have re-observed the entry's finding? False when
    the entry's checker did not run or its file was not scanned."""
    if checkers is not None and entry.get("checker") not in checkers:
        return False
    if (
        scanned_paths is not None
        and entry.get("path") not in scanned_paths
    ):
        return False
    return True


def apply_baseline(
    findings: List[Finding],
    entries: List[Dict[str, Any]],
    scanned_paths: Optional[Set[str]] = None,
    checkers: Optional[Set[str]] = None,
) -> Tuple[List[Finding], List[Finding]]:
    """Mark baselined findings; return (stale-entry, unannotated-entry)
    findings for entries that no longer match / carry no note. Entries
    outside the run's scope (see `entry_in_scope`) are never stale: a
    partial run could not have re-observed them."""
    by_fp: Dict[str, Finding] = {}
    for f in findings:
        if f.suppressed_by is None:
            by_fp.setdefault(f.fingerprint(), f)
    extra: List[Finding] = []
    for entry in entries:
        fp = str(entry.get("fingerprint", ""))
        matched = by_fp.get(fp)
        if matched is None and not entry_in_scope(
            entry, scanned_paths, checkers
        ):
            continue
        if matched is not None:
            matched.baselined = True
            note = str(entry.get("note", "") or "")
            if not note.strip() or note.strip() == _TODO:
                extra.append(
                    Finding(
                        "baseline", "CEP-B02", BASELINE_NAME, 0,
                        f"baseline entry {fp} ({entry.get('code')}, "
                        f"{entry.get('path')}) has no note -- justify it "
                        "or fix the finding",
                        context=f"unannotated:{fp}",
                    )
                )
        else:
            extra.append(
                Finding(
                    "baseline", "CEP-B01", BASELINE_NAME, 0,
                    f"stale baseline entry {fp} ({entry.get('code')}, "
                    f"{entry.get('path')}): no current finding matches -- "
                    "remove it (or run --update-baseline)",
                    context=f"stale:{fp}",
                )
            )
    return [f for f in extra if f.code == "CEP-B01"], [
        f for f in extra if f.code == "CEP-B02"
    ]


def update(
    path: str,
    findings: List[Finding],
    entries: List[Dict[str, Any]],
    scanned_paths: Optional[Set[str]] = None,
    checkers: Optional[Set[str]] = None,
) -> List[Dict[str, Any]]:
    """Rewrite the baseline to the current unsuppressed findings,
    keeping notes of surviving entries (expire semantics: anything not
    re-observed drops out).

    `scanned_paths`/`checkers` bound the rewrite to the run's scope: an
    entry whose checker did not run, or whose file was not scanned, was
    never re-observable -- a partial run (`ceplint one/file.py` or
    `--checker zerosync`) must not silently erase unrelated entries and
    their human-written notes."""
    notes = {
        str(e.get("fingerprint", "")): str(e.get("note", "") or "")
        for e in entries
    }
    out: List[Dict[str, Any]] = []
    seen_fps: set = set()
    for e in entries:
        if not entry_in_scope(e, scanned_paths, checkers):
            out.append(dict(e))
            seen_fps.add(str(e.get("fingerprint", "")))
    for f in findings:
        if f.suppressed_by is not None or f.checker == "baseline":
            continue
        fp = f.fingerprint()
        if fp in seen_fps:
            continue
        out.append(
            {
                "fingerprint": fp,
                "checker": f.checker,
                "code": f.code,
                "path": f.path,
                "message": f.message,
                "note": notes.get(fp, "") or _TODO,
            }
        )
    save(path, out)
    return out
