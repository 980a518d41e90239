"""The port's ceplint CLI: `python -m kafkastreams_cep_tpu_torch.analysis`.

A copy of the JAX package's `analysis/cli.py` over the port's roots and
baseline. Exit codes (tests/test_torch_lint.py pins them):
    0  clean: no unbaselined findings, baseline fully live + annotated
    1  findings (unbaselined, stale baseline entries, or unannotated
       baseline entries) -- or a kernel-build audit violation
    2  usage / internal error

``--all`` scans the port package; explicit paths scan just those
files/trees (doc-side staleness checks that need the whole picture
disable themselves on partial scans). ``--kernel-audit`` additionally
runs the runtime kernel-build audit (analysis/kernel_audit.py: imports
torch, and runs on the card unless ``--device cpu``; the static checkers
never import torch).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import baseline as baseline_mod
from .core import (
    CHECKERS,
    DEFAULT_ROOTS,
    Finding,
    iter_source_files,
    repo_root,
    run_checkers,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kafkastreams_cep_tpu_torch.analysis",
        description=(
            "invariant-enforcing static analysis of the PyTorch port: "
            "zero-sync hot paths, thread-shared state, kernel-build "
            "hazards, serde/metrics/trace completeness"
        ),
    )
    p.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: --all roots)",
    )
    p.add_argument(
        "--all", action="store_true",
        help=f"lint the default roots: {', '.join(DEFAULT_ROOTS)}",
    )
    p.add_argument(
        "--checker", action="append", default=None, metavar="NAME",
        help="run only this checker (repeatable); default: all of "
        + ", ".join(sorted(CHECKERS)),
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: <repo>/ceplint_torch.baseline.json)",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current findings "
        "(new entries get a TODO note that must be annotated)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file entirely (raw findings)",
    )
    p.add_argument(
        "--json", action="store_true", dest="as_json",
        help="machine-readable output (one document, findings array)",
    )
    p.add_argument(
        "--kernel-audit", action="store_true",
        help="also replay same-shape epochs and assert that no kernel "
        "build, module load or cep_compiles_total{fn} moves (imports "
        "torch; runs on the card unless --device cpu)",
    )
    p.add_argument(
        "--device", default=None, metavar="DEVICE",
        help="where --kernel-audit runs (default: the card)",
    )
    p.add_argument(
        "--root", default=None, help=argparse.SUPPRESS
    )  # test hook: analyze a different tree as if it were the repo
    return p


def _finding_doc(f: Finding) -> dict:
    return {
        "fingerprint": f.fingerprint(),
        "checker": f.checker,
        "code": f.code,
        "path": f.path,
        "line": f.line,
        "message": f.message,
        "suppressed": f.suppressed_by is not None,
        "suppression_reason": (
            f.suppressed_by.reason if f.suppressed_by is not None else None
        ),
        "baselined": f.baselined,
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.no_baseline and args.update_baseline:
        # "ignore the baseline" and "rewrite the baseline" contradict;
        # honoring both would rewrite the file from an empty entry list
        # and erase out-of-scope entries with their notes.
        print(
            "ceplint: error: --no-baseline and --update-baseline are "
            "mutually exclusive",
            file=sys.stderr,
        )
        return 2
    root_dir = args.root or repo_root()
    try:
        roots = args.paths or list(DEFAULT_ROOTS)
        if args.all and args.paths:
            roots = list(DEFAULT_ROOTS) + args.paths
        files = iter_source_files(roots, root_dir=root_dir)
        if not files:
            # A typo'd path (or wrong cwd) must not read as a green gate.
            print(
                "ceplint: error: no Python files found under: "
                + ", ".join(roots),
                file=sys.stderr,
            )
            return 2
        findings = run_checkers(files, args.checker, root_dir=root_dir)
    except (SyntaxError, OSError, KeyError) as exc:
        print(f"ceplint: error: {exc}", file=sys.stderr)
        return 2

    bl_path = args.baseline or baseline_mod.default_path(root_dir)
    from .metrics_check import DICT_PATH, PERF_PATH

    # The run's scope: which entries this run could have re-observed
    # (partial runs must neither erase nor stale-flag the rest).
    scanned_paths = {src.relpath for src in files} | {PERF_PATH, DICT_PATH}
    scope_checkers = set(args.checker or CHECKERS) | {"pragma"}
    try:
        entries = [] if args.no_baseline else baseline_mod.load(bl_path)
        if args.update_baseline:
            entries = baseline_mod.update(
                bl_path, findings, entries,
                scanned_paths=scanned_paths, checkers=scope_checkers,
            )
    except (ValueError, OSError) as exc:
        # A corrupt baseline is an internal error (exit 2), never
        # "findings present" -- json.JSONDecodeError is a ValueError.
        print(f"ceplint: error: baseline {bl_path}: {exc}", file=sys.stderr)
        return 2
    stale, unannotated = baseline_mod.apply_baseline(
        findings, entries,
        scanned_paths=scanned_paths, checkers=scope_checkers,
    )
    findings = findings + stale + unannotated

    if args.kernel_audit:
        from .kernel_audit import run_kernel_build_audit

        try:
            findings = findings + run_kernel_build_audit(device=args.device)
        except (RuntimeError, ValueError) as exc:
            # No card (or a refused device): the audit could not run.
            print(f"ceplint: error: kernel audit: {exc}", file=sys.stderr)
            return 2

    active = [
        f for f in findings if f.suppressed_by is None and not f.baselined
    ]
    if args.as_json:
        print(
            json.dumps(
                {
                    "tool": "ceplint",
                    "roots": roots,
                    "checkers": args.checker or sorted(CHECKERS),
                    "findings": [_finding_doc(f) for f in findings],
                    "active": len(active),
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            if f.suppressed_by is not None:
                continue  # audited in source; not even noise
            marker = " [baselined]" if f.baselined else ""
            print(f.render() + marker)
        n_sup = sum(1 for f in findings if f.suppressed_by is not None)
        n_base = sum(1 for f in findings if f.baselined)
        print(
            f"ceplint: {len(active)} finding(s), {n_sup} pragma-audited, "
            f"{n_base} baselined, {len(files)} file(s) scanned"
        )
    return 1 if active else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
