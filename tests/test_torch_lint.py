"""The port's ceplint gate (`kafkastreams_cep_tpu_torch/analysis/`).

Counterparts of tests/test_lint.py for the port: the green gate over the
port package within its runtime budget, one seeded mutation fixture per
checker under tests/fixtures/lint_torch/ (each proving its gate can
fail), pragma grammar, baseline add/expire, CLI exit codes, the
kernel-build audit (flat and seeded churn) and the runtime lock-order
monitor. Where a rule is shared with the JAX package's `analysis/`, the
port is held to it on the same inputs: pragma parsing and fingerprints,
baseline semantics, CLI exit codes, the thread and serde checkers on the
JAX fixtures, the metrics diff on one dictionary, and the two lock monitors
on the same scripted lock sequences (equal edges and cycles).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest

from kafkastreams_cep_tpu.analysis import baseline as jax_baseline
from kafkastreams_cep_tpu.analysis import core as jax_core
from kafkastreams_cep_tpu.analysis import serde_check as jax_serde
from kafkastreams_cep_tpu.analysis.cli import main as jax_main
from kafkastreams_cep_tpu.analysis.lockmon import LockMonitor as JaxLockMonitor
from kafkastreams_cep_tpu_torch.analysis import baseline as baseline_mod
from kafkastreams_cep_tpu_torch.analysis import core, serde_check, trace_check, zerosync
from kafkastreams_cep_tpu_torch.analysis.cli import main as lint_main
from kafkastreams_cep_tpu_torch.analysis.lockmon import LockMonitor, active_monitor, lock_monitor

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "fixtures", "lint_torch")
JAX_FIXTURES = os.path.join("tests", "fixtures", "lint")


def findings_for(paths, checkers=None, root_dir=REPO, mod=core):
    files = mod.iter_source_files(
        paths if isinstance(paths, (list, tuple)) else [paths], root_dir=root_dir)
    return mod.run_checkers(files, checkers, root_dir=root_dir)


def active(findings):
    return [f for f in findings if f.suppressed_by is None and not f.baselined]


def codes(findings):
    return {f.code for f in active(findings)}


def fx(name):
    return os.path.join(FIXTURES, name).replace(os.sep, "/")


def bind_serde_fixture(monkeypatch):
    structs, frames = fx("serde_structs.py"), fx("serde_violation.py")
    monkeypatch.setattr(serde_check, "SERDE_PATH", frames)
    monkeypatch.setattr(serde_check, "STRUCT_BINDINGS",
                        ((structs, "Record", "encode_record", "decode_record"),))
    monkeypatch.setattr(serde_check, "DICT_BINDINGS", (
        (structs, "Gate.snapshot_state", "Gate.restore_state",
         "encode_gate_state", "decode_gate_state"),
        (structs, "Shard.checkpoint", (("Shard.adopt", "cp"), ("sessions_of", "")),
         "encode_shard", "decode_shard"),
    ))
    return structs, frames


def bind_trace_fixture(monkeypatch):
    path = fx("trace_violation.py")
    monkeypatch.setattr(trace_check, "TRACE_FILES", (path,))
    monkeypatch.setattr(trace_check, "TRACE_BINDINGS",
                        ((path, "forward_traced"), (path, "stamp_ingest"), (path, "gone")))
    return path


# --------------------------------------------------------- the tier-1 gate
def test_full_package_green_within_budget():
    """The gate over the port package: zero active findings, and the
    static pass fits the <= 10 s budget (in process)."""
    t0 = time.perf_counter()
    rc = lint_main(["--all"])
    wall = time.perf_counter() - t0
    assert rc == 0
    assert wall < 10.0, f"static lint took {wall:.1f}s (budget 10s)"


def test_repo_has_audited_sites_not_silence():
    """Green because sites were audited, not because the checkers match
    nothing: the port carries pragma'd thread, serde and trace sites, and
    the zero-sync scan's listed exception is hot and does read the host."""
    findings = findings_for(core.DEFAULT_ROOTS)
    suppressed = [f for f in findings if f.suppressed_by is not None]
    assert len(suppressed) >= 8
    assert {f.checker for f in suppressed} >= {"threads", "serde", "tracectx"}
    for f in suppressed:
        assert f.suppressed_by.has_reason
    assert zerosync.excepted_hits() == [("ops/gc_kernel.py", "_walk")]


# ------------------------------------------------------- mutation fixtures
def test_zerosync_fixture_flagged():
    fs = active(findings_for(fx("zerosync_violation.py"), ["zerosync"]))
    got = {f.code for f in fs}
    assert {"CEP-S01", "CEP-S02", "CEP-S03"} <= got
    # .item(), synchronize and np.asarray all land; int() + bool() land.
    assert sum(1 for f in fs if f.code == "CEP-S01") >= 3
    assert sum(1 for f in fs if f.code == "CEP-S02") >= 2
    # The unmarked function is never hot: every finding names hot_advance.
    assert all(f.function == "hot_advance" for f in fs)
    assert all("hot_advance" in f.message for f in fs)


def test_threads_fixture_flagged():
    fs = active(findings_for(fx("threads_violation.py"), ["threads"]))
    t01 = [f for f in fs if f.code == "CEP-T01"]
    t03 = [f for f in fs if f.code == "CEP-T03"]
    assert len(t01) == 2  # the two unguarded counter writes
    assert all("counter" in f.message for f in t01)
    assert "executor:_pool" in t01[0].message
    assert len(t03) == 1  # the anonymous pool
    assert not any("self.ok" in f.message for f in fs)


def test_recompile_fixture_flagged():
    fs = active(findings_for(fx("recompile_violation.py"), ["recompile"]))
    assert {f.code for f in fs} == {"CEP-R01", "CEP-R02", "CEP-R03"}
    r03 = [f for f in fs if f.code == "CEP-R03"]
    assert any("_LIBS" in f.message for f in r03)
    assert any("build_for" in f.message for f in r03)
    assert any("NfaStep" in f.message for f in fs if f.code == "CEP-R02")


def test_serde_fixture_flagged(monkeypatch):
    structs, frames = bind_serde_fixture(monkeypatch)
    fs = active(findings_for([structs, frames], ["serde"]))
    msgs = "\n".join(f.message for f in fs)
    assert any(f.code == "CEP-D01" and "Record.c" in f.message for f in fs)
    assert any(f.code == "CEP-D01" and "'z'" in f.message for f in fs)
    assert any(f.code == "CEP-D03" and "'q'" in f.message for f in fs)
    assert any(f.code == "CEP-D03" and "'y'" in f.message and "never consumes" in f.message
               for f in fs)
    # The shard-frame shape: a producer returning encode({...}); 'pos' is
    # consumed through decode_shard(blob)["pos"], 'lost' is dropped.
    assert any(f.code == "CEP-D01" and "'lost'" in f.message for f in fs)
    assert "'pos'" not in msgs and "'id'" not in msgs
    assert "skipme" not in msgs


def test_trace_fixture_flagged(monkeypatch):
    path = bind_trace_fixture(monkeypatch)
    fs = findings_for(path, ["tracectx"])
    w01 = [f for f in fs if f.code == "CEP-W01"]
    assert [f.line for f in active(w01)] == [11]
    assert [f.line for f in w01 if f.suppressed_by is not None] == [19]
    w02 = sorted(f.message.split()[0] for f in active(fs) if f.code == "CEP-W02")
    assert w02 == ["stamp_ingest", "trace"]  # the silent hop, the missing row


def _dictionary(body, begin="ceplint-torch", end="ceplint-torch"):
    return (f'"""Metrics.\n\n<!-- {begin}:metrics-dictionary:begin -->\n' + body
            + f'<!-- {end}:metrics-dictionary:end -->\n"""\n')


def test_metrics_fixture_flagged(tmp_path):
    pkg = tmp_path / "kafkastreams_cep_tpu_torch" / "obs"
    pkg.mkdir(parents=True)
    (pkg / "registry.py").write_text(
        "class R:\n"
        "    def setup(self, reg):\n"
        '        reg.counter("cep_undocumented_total", "seeded")\n'
        '        reg.gauge("cep_documented_gauge", "fine")\n'
    )
    body = ("- `cep_documented_gauge` -- fine\n"
            "- `cep_ghost_total` -- registered by no code\n")
    (pkg / "metrics_dictionary.py").write_text(_dictionary(body))
    fs = active(findings_for(["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path)))
    assert any(f.code == "CEP-M01" and "cep_undocumented_total" in f.message for f in fs)
    assert any(f.code == "CEP-M02" and "cep_ghost_total" in f.message for f in fs)
    assert not any("cep_documented_gauge" in f.message for f in fs)
    # PERF.md's copy of the section is held equal to the dictionary where
    # it has one; a checkout without it (or without PERF.md) is not a
    # finding, since the documents need not travel with the code.
    assert "CEP-M04" not in {f.code for f in fs}
    (tmp_path / "PERF.md").write_text("# perf\n")
    assert {f.code for f in active(findings_for(
        ["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path)))} == {
        "CEP-M01", "CEP-M02"}
    (tmp_path / "PERF.md").write_text(
        "# perf\n<!-- ceplint-torch:metrics-dictionary:begin -->\n"
        "- `cep_documented_gauge` · `cep_perf_only`\n"
        "<!-- ceplint-torch:metrics-dictionary:end -->\n")
    fs = active(findings_for(["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path)))
    assert sorted((f.path, f.context) for f in fs if f.code == "CEP-M04") == [
        ("PERF.md", "perf-only:cep_perf_only"),
        ("kafkastreams_cep_tpu_torch/obs/metrics_dictionary.py",
         "dictionary-only:cep_ghost_total")]
    # The JAX package's markers are not the port's: missing markers are
    # their own loud finding, and so is a missing dictionary.
    (pkg / "metrics_dictionary.py").write_text(_dictionary(body, "ceplint", "ceplint"))
    fs2 = active(findings_for(["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path)))
    assert [f.code for f in fs2] == ["CEP-M03"]
    (pkg / "metrics_dictionary.py").unlink()
    fs3 = active(findings_for(["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path)))
    assert [f.code for f in fs3] == ["CEP-M03"]


def test_repo_perf_md_repeats_the_port_dictionary():
    """The repo's PERF.md carries the port's section after the JAX one,
    naming the same metrics as obs/metrics_dictionary.py (which the gate
    reads), and the JAX section stays the first pair of markers."""
    from kafkastreams_cep_tpu_torch.analysis import metrics_check as mc

    text = open(os.path.join(REPO, "PERF.md"), encoding="utf-8").read()
    assert text.index("<!-- ceplint:metrics-dictionary:end -->") < text.index(mc.BEGIN)
    in_perf = mc.section_names(os.path.join(REPO, "PERF.md"))
    in_dict = mc.section_names(os.path.join(REPO, mc.DICT_PATH))
    assert in_perf and set(in_perf) == set(in_dict)
    assert mc.perf_md_drift(REPO, in_dict) == []


# ---------------------------------------------------------- pragma grammar
def test_pragma_suppression_requires_reason(tmp_path):
    (tmp_path / "mod.py").write_text(
        "# cep: hot-path\n"
        "def hot(state):\n"
        "    a = state['x'].item()  # cep: sync-ok(audited: drain point)\n"
        "    b = state['y'].item()  # cep: sync-ok\n"
        "    c = state['z'].item()  # cep: bogus-kind(what)\n"
        "    return a, b, c\n"
    )
    fs = findings_for(["mod.py"], root_dir=str(tmp_path))
    by_line = {}
    for f in fs:
        by_line.setdefault(f.line, []).append(f)
    line3 = [f for f in by_line.get(3, []) if f.checker == "zerosync"]
    assert line3 and all(f.suppressed_by is not None for f in line3)
    assert line3[0].suppressed_by.reason == "audited: drain point"
    assert {"CEP-S01", "CEP-P01"} <= {f.code for f in by_line.get(4, [])}
    assert {"CEP-S01", "CEP-P02"} <= {f.code for f in by_line.get(5, [])}


def test_pragma_in_string_literal_is_inert(tmp_path):
    (tmp_path / "mod.py").write_text(
        'DOC = "use # cep: sync-ok(reason) to audit a site"\n'
        "# cep: hot-path\n"
        "def hot(state):\n"
        '    s = "# cep: sync-ok(not a comment)"\n'
        "    return state['x'].item(), s\n"
    )
    fs = findings_for(["mod.py"], root_dir=str(tmp_path))
    s01 = [f for f in fs if f.code == "CEP-S01"]
    assert len(s01) == 1 and s01[0].suppressed_by is None
    assert not any(f.checker == "pragma" for f in fs)


def test_hot_path_marker_on_def_line(tmp_path):
    (tmp_path / "mod.py").write_text(
        "def cold(state):\n"
        "    return state['x'].item()\n"
        "def hot(state):  # cep: hot-path\n"
        "    return state['x'].item()\n"
    )
    fs = active(findings_for(["mod.py"], ["zerosync"], root_dir=str(tmp_path)))
    assert len(fs) == 1 and fs[0].line == 4


def test_scan_honours_sync_ok_and_the_hot_path_marker():
    """`zerosync.scan()` (the port's older entry) reports core findings,
    drops a line audited with sync-ok(reason) and scans a function a
    hot-path pragma marks."""
    src = zerosync.source("parallel/batched.py")
    anchor = "        self._batches += 1\n"
    assert anchor in src
    read = "        self._n = int(self.state['n_events'].sum())"
    found = zerosync.scan({"parallel/batched.py": src.replace(anchor, anchor + read + "\n", 1)})
    assert [(f.code, f.function) for f in found] == [
        ("CEP-S02", "BatchedDeviceNFA.advance_packed")]
    assert isinstance(found[0], core.Finding) and found[0].checker == "zerosync"
    audited = read + "  # cep: sync-ok(test: an audited read)\n"
    assert zerosync.scan({"parallel/batched.py": src.replace(anchor, anchor + audited, 1)}) == []
    marked = src + "\n\n# cep: hot-path\ndef _probe(state):\n    return state['x'].cpu()\n"
    found = zerosync.scan({"parallel/batched.py": marked})
    assert [(f.function, f.construct) for f in found] == [("_probe", ".cpu()")]


# ------------------------------------------------------ baseline semantics
def test_baseline_add_annotate_expire(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    shutil.copy(os.path.join(REPO, FIXTURES, "zerosync_violation.py"), mod)
    bl = tmp_path / baseline_mod.BASELINE_NAME
    args = ["mod.py", "--root", str(tmp_path), "--baseline", str(bl), "--checker", "zerosync"]
    assert lint_main(args) == 1
    assert lint_main(args + ["--update-baseline"]) == 1
    entries = baseline_mod.load(str(bl))
    assert entries and all(e["note"] == "TODO: annotate" for e in entries)
    for e in entries:
        e["note"] = "accepted: fixture exercising the gate"
    baseline_mod.save(str(bl), entries)
    assert lint_main(args) == 0
    assert "[baselined]" in capsys.readouterr().out
    mod.write_text("def clean():\n    return 1\n")
    assert lint_main(args) == 1
    out = capsys.readouterr().out
    assert "CEP-B01" in out and "stale" in out
    assert lint_main(args + ["--update-baseline"]) == 0
    assert baseline_mod.load(str(bl)) == []


def test_committed_baseline_is_empty_or_annotated():
    path = os.path.join(REPO, baseline_mod.BASELINE_NAME)
    assert os.path.exists(path) and baseline_mod.BASELINE_NAME == "ceplint_torch.baseline.json"
    for e in baseline_mod.load(path):
        note = str(e.get("note", "")).strip()
        assert note and note != "TODO: annotate", e


# -------------------------------------------------------- CLI + exit codes
def test_cli_unknown_checker_exits_2(capsys):
    assert lint_main(["--all", "--checker", "bogus"]) == 2
    assert "unknown checker" in capsys.readouterr().err


@pytest.mark.parametrize("name,checker", [
    ("zerosync_violation.py", "zerosync"),
    ("threads_violation.py", "threads"),
    ("recompile_violation.py", "recompile"),
    ("serde_violation.py", "serde"),
    ("trace_violation.py", "tracectx"),
])
def test_cli_fixture_exits_1(name, checker, monkeypatch, capsys):
    """Each fixture exits 1 through the CLI (serde and trace with the
    fixture's bindings in place, as their tests bind them)."""
    paths = [fx(name)]
    if checker == "serde":
        paths = list(bind_serde_fixture(monkeypatch))
    elif checker == "tracectx":
        bind_trace_fixture(monkeypatch)
    rc = lint_main(paths + ["--checker", checker, "--no-baseline"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "CEP-" in out and "finding(s)" in out


def test_cli_json_and_module_entry():
    proc = subprocess.run(
        [sys.executable, "-m", "kafkastreams_cep_tpu_torch.analysis", "--all", "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    doc = json.loads(proc.stdout)
    assert doc["tool"] == "ceplint" and doc["active"] == 0
    assert doc["roots"] == ["kafkastreams_cep_tpu_torch"]
    assert any(f["suppressed"] for f in doc["findings"])
    for f in doc["findings"]:
        if f["suppressed"]:
            assert f["suppression_reason"]


def test_cli_zero_files_scanned_is_an_error(capsys):
    assert lint_main(["kafkastreams_cep_tpu_torch/obs/typo.py", "--checker", "zerosync"]) == 2
    assert "no Python files found" in capsys.readouterr().err


def test_cli_corrupt_baseline_is_an_error(tmp_path, capsys):
    bad = tmp_path / "bl.json"
    bad.write_text("not json")
    assert lint_main(["--all", "--baseline", str(bad)]) == 2
    assert "baseline" in capsys.readouterr().err


def test_cli_no_baseline_update_baseline_conflict(capsys):
    assert lint_main(["--all", "--no-baseline", "--update-baseline"]) == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_partial_update_preserves_out_of_scope_entries(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    shutil.copy(os.path.join(REPO, FIXTURES, "zerosync_violation.py"), mod)
    bl = tmp_path / baseline_mod.BASELINE_NAME
    foreign = {
        "fingerprint": "feedfacefeedface", "checker": "metrics", "code": "CEP-M02",
        "path": "PERF.md", "message": "stale doc entry accepted during migration",
        "note": "accepted: a dashboard still reads it",
    }
    baseline_mod.save(str(bl), [foreign])
    args = ["mod.py", "--root", str(tmp_path), "--baseline", str(bl), "--checker", "zerosync"]
    assert lint_main(args) == 1
    assert "CEP-B01" not in capsys.readouterr().out
    assert lint_main(args + ["--update-baseline"]) == 1
    entries = baseline_mod.load(str(bl))
    assert [e for e in entries if e["checker"] == "metrics"] == [foreign]
    assert any(e["checker"] == "zerosync" for e in entries)


def test_worker_only_helper_does_not_inherit_parent_roots(tmp_path):
    (tmp_path / "mod.py").write_text(
        "import threading\n"
        "class Pump:\n"
        "    def __init__(self):\n"
        "        self.n = 0\n"
        "    def start(self):\n"
        "        def _run():\n"
        "            self._bump()\n"
        "        threading.Thread(target=_run, name='w').start()\n"
        "    def _bump(self):\n"
        "        self.n += 1\n"
    )
    fs = active(findings_for(["mod.py"], ["threads"], root_dir=str(tmp_path)))
    assert not any(f.code == "CEP-T01" for f in fs), [f.message for f in fs]


def test_thread_roots_table_matches_the_port():
    """Every EXTRA_ROOTS row names methods of the port (a stale row is
    CEP-T02), and a renamed root is reported."""
    from kafkastreams_cep_tpu_torch.analysis import threads

    rel = "kafkastreams_cep_tpu_torch/streams/driver.py"
    assert "LogDriver.maybe_report" in threads.EXTRA_ROOTS[rel]
    src = core.SourceFile(os.path.join(REPO, rel), rel,
                          open(os.path.join(REPO, rel)).read().replace(
                              "def maybe_report(", "def maybe_report_renamed("))
    fs = threads.check([src], REPO)
    assert [f.code for f in fs if f.code == "CEP-T02"] == ["CEP-T02"]


# -------------------------------------------------------- kernel-build audit
def test_kernel_build_audit_flat_on_same_shapes():
    """Same-shape epochs (deferred advances, drains, snapshot/restore
    round trips onto the same registry, identical traffic re-packed) move
    no kernel counter after the warm epoch."""
    from kafkastreams_cep_tpu_torch.analysis.kernel_audit import run_kernel_build_audit

    report = {}
    assert run_kernel_build_audit(device="cpu", report=report) == []
    assert report["warm"]["compiles:nfa_step"] == 1
    assert report["epochs"] == [report["warm"]] * 2
    assert report["matches_drained"] > 0


def test_kernel_build_audit_catches_shape_churn():
    """Seeded violation: a capacity that changes every epoch is a new
    kernel signature each time, and the audit says so."""
    from kafkastreams_cep_tpu_torch.analysis.kernel_audit import run_kernel_build_audit

    fs = run_kernel_build_audit(device="cpu", epochs=1, batches_per_epoch=2, vary_shapes=True)
    assert fs and all(f.code == "CEP-J01" for f in fs)
    assert any("cep_compiles_total" in f.message for f in fs)


def test_kernel_audit_runs_on_the_card_unless_told_otherwise(capsys):
    """The audit's default device is the card: without one it raises
    (here), and the CLI's --kernel-audit exits 2 unless --device cpu."""
    from kafkastreams_cep_tpu_torch.analysis.kernel_audit import run_kernel_build_audit

    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_kernel_build_audit()
        assert lint_main([fx("zerosync_violation.py"), "--checker", "zerosync",
                          "--kernel-audit"]) == 2
        assert "kernel audit" in capsys.readouterr().err


def test_cli_kernel_audit_on_the_cpu_stays_flat(capsys):
    rc = lint_main(["kafkastreams_cep_tpu_torch/ops/kernel_build.py", "--kernel-audit",
                    "--device", "cpu", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["active"] == 0
    assert not any(f["code"] == "CEP-J01" for f in doc["findings"])


def test_a_restored_engine_counts_no_signature_twice():
    """cep_compiles_total counts a signature once a registry: an engine
    restored onto its predecessor's registry loads the same kernel and
    counts nothing (the fault the kernel audit found)."""
    import kafkastreams_cep_tpu_torch as P
    from kafkastreams_cep_tpu_torch.models.stocks import stocks_pattern
    from kafkastreams_cep_tpu_torch.models.cases import STOCK_FIELDS

    reg = P.MetricsRegistry()
    q = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    cfg = P.EngineConfig(lanes=32, nodes=512, matches=64)
    eng = P.BatchedDeviceNFA(q, keys=["a"], config=cfg, device="cpu", engine="cuda",
                             registry=reg)
    again = P.BatchedDeviceNFA.restore(q, eng.snapshot(), config=cfg, device="cpu",
                                       engine="cuda", registry=reg)
    assert eng.compile_watch.compiles("nfa_step") == 1
    assert again.compile_watch.compiles("nfa_step") == 1 and again.compile_watch.seen_count == 1
    other = P.BatchedDeviceNFA(q, keys=["a"], config=cfg, device="cpu", engine="cuda")
    assert other.compile_watch.compiles("nfa_step") == 1  # a registry of its own


def test_loaded_modules_count_each_library_once_a_device():
    from kafkastreams_cep_tpu_torch.ops import kernel_build

    class Lib:
        _name = "/nowhere/fake_kernel_test.so"

    before = kernel_build.loaded_modules().get("cpu", 0)
    for _ in range(3):
        with kernel_build.on_device(__import__("torch").device("cpu"), Lib()):
            pass
    assert kernel_build.loaded_modules()["cpu"] == before + 1
    with kernel_build.on_device(__import__("torch").device("cpu")):
        pass
    assert kernel_build.loaded_modules()["cpu"] == before + 1


# -------------------------------------------------------- lock-order monitor
def test_lockmon_detects_inverted_order():
    with lock_monitor() as mon:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    cycles = mon.cycles()
    assert cycles, mon.report()
    assert any(len(set(c)) == 2 for c in cycles)
    assert "CYCLE" in mon.report()


def test_lockmon_consistent_order_is_clean():
    with lock_monitor() as mon:
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
    assert mon.cycles() == []
    assert mon.acquires >= 6


def test_lockmon_wrappers_delegate_and_survive_disarm():
    with lock_monitor():
        lock = threading.Lock()
        cond = threading.Condition()  # allocates an instrumented RLock
        with cond:
            cond.notify_all()
        assert lock.acquire(False) is True
        assert lock.locked()
        lock.release()
    assert lock.acquire(False) is True
    lock.release()
    assert not hasattr(threading.Lock(), "_mon")


def test_lockmon_cross_thread_edges_record_thread_names():
    with lock_monitor() as mon:
        a = threading.Lock()
        b = threading.Lock()

        def worker():
            with a:
                with b:
                    pass

        t = threading.Thread(target=worker, name="kct-lint-worker")
        t.start()
        t.join()
    assert any("kct-lint-worker" in names for names in mon.edges.values())


def test_lockmon_nests_under_the_jax_monitor():
    """Armed inside the JAX package's monitor (as the shared conftest arms
    it), the port's monitor restores the JAX one's constructors, records
    the locks made in its window, and leaves the stdlib's at the end."""
    std_lock, std_rlock = threading.Lock, threading.RLock
    outer = JaxLockMonitor().install()
    try:
        jax_lock, jax_rlock = threading.Lock, threading.RLock
        with lock_monitor() as inner:
            assert active_monitor() is inner
            a = threading.Lock()
            b = threading.RLock()
            with a:
                with b:
                    pass
        assert threading.Lock is jax_lock and threading.RLock is jax_rlock
        assert active_monitor() is None and len(inner.edges) == 1
        assert outer.edges == {}  # the inner window's locks are the port's
    finally:
        outer.uninstall()
    assert threading.Lock is std_lock and threading.RLock is std_rlock


# ------------------------------------------------ port against JAX, shared rules
PRAGMA_TEXTS = [
    "# cep: hot-path\ndef hot(state):\n    a = state['x'].item()  # cep: sync-ok(drain)\n"
    "    b = state['y'].item()  # cep: sync-ok\n    return a, b  # cep: bogus(x)\n",
    "class W:\n    def run(self):\n        self.n = 1  # cep: thread-ok(joined) cep: serde-ok()\n",
    'DOC = "# cep: sync-ok(in a string)"\n# cep: metric-ok(doc)  cep: trace-ok(ctl)\n',
]


@pytest.mark.parametrize("text", PRAGMA_TEXTS)
def test_pragmas_and_fingerprints_match_jax(text):
    mine = core.SourceFile("m.py", "m.py", text)
    ref = jax_core.SourceFile("m.py", "m.py", text)
    assert {k: [(p.kind, p.reason, p.line) for p in v] for k, v in mine.pragmas.items()} == {
        k: [(p.kind, p.reason, p.line) for p in v] for k, v in ref.pragmas.items()}
    got = [(f.code, f.line, f.fingerprint()) for f in core.pragma_findings(mine)]
    want = [(f.code, f.line, f.fingerprint()) for f in jax_core.pragma_findings(ref)]
    assert got == want
    f1 = core.Finding("zerosync", "CEP-S01", "a/b.py", 3, "m", context="x = y.item()")
    f2 = jax_core.Finding("zerosync", "CEP-S01", "a/b.py", 9, "m", context="x = y.item()")
    assert f1.fingerprint() == f2.fingerprint()


def _pair_findings(mod):
    return [
        mod.Finding("zerosync", "CEP-S01", "p.py", 3, "m1", context="a.item()"),
        mod.Finding("threads", "CEP-T01", "q.py", 7, "m2", context="self.n += 1"),
        mod.Finding("metrics", "CEP-M02", "PERF.md", 0, "m3", context="metric:cep_x"),
    ]


def test_baseline_semantics_match_jax(tmp_path):
    found = {"port": _pair_findings(core), "jax": _pair_findings(jax_core)}
    entries = [
        {"fingerprint": found["port"][0].fingerprint(), "checker": "zerosync",
         "code": "CEP-S01", "path": "p.py", "note": "accepted"},
        {"fingerprint": found["port"][1].fingerprint(), "checker": "threads",
         "code": "CEP-T01", "path": "q.py", "note": "TODO: annotate"},
        {"fingerprint": "deadbeefdeadbeef", "checker": "serde", "code": "CEP-D01",
         "path": "r.py", "note": "gone"},
        {"fingerprint": "feedfacefeedface", "checker": "serde", "code": "CEP-D01",
         "path": "other.py", "note": "out of scope"},
    ]
    out = {}
    for name, mod in (("port", baseline_mod), ("jax", jax_baseline)):
        fs = found[name]
        stale, todo = mod.apply_baseline(fs, entries, scanned_paths={"p.py", "q.py", "r.py"})
        path = tmp_path / f"{name}.json"
        kept = mod.update(str(path), fs, entries, scanned_paths={"p.py", "q.py", "r.py"},
                          checkers={"zerosync", "threads", "serde", "metrics"})
        out[name] = ([f.baselined for f in fs], [f.context for f in stale],
                     [f.context for f in todo], kept)
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("case", ["fixture", "unknown", "typo", "conflict", "corrupt", "clean"])
def test_cli_exit_codes_match_jax(case, tmp_path, capsys):
    bad = tmp_path / "bl.json"
    bad.write_text("not json")
    (tmp_path / "clean.py").write_text("def f():\n    return 1\n")
    args = {
        "fixture": lambda d: [os.path.join(d, "zerosync_violation.py"), "--checker", "zerosync",
                              "--no-baseline"],
        "unknown": lambda d: [os.path.join(d, "zerosync_violation.py"), "--checker", "bogus"],
        "typo": lambda d: [os.path.join(d, "typo.py"), "--checker", "zerosync"],
        "conflict": lambda d: [os.path.join(d, "zerosync_violation.py"), "--no-baseline",
                               "--update-baseline"],
        "corrupt": lambda d: [os.path.join(d, "zerosync_violation.py"), "--checker",
                              "zerosync", "--baseline", str(bad)],
        "clean": lambda d: [str(tmp_path / "clean.py"), "--checker", "zerosync",
                            "--no-baseline"],
    }[case]
    got = lint_main(args(FIXTURES))
    want = jax_main(args(JAX_FIXTURES))
    assert got == want == {"fixture": 1, "clean": 0}.get(case, 2)
    capsys.readouterr()


def _shape(findings):
    return sorted((f.code, f.line, f.context) for f in active(findings))


def test_threads_checker_matches_jax_on_the_jax_fixture():
    path = os.path.join(JAX_FIXTURES, "threads_violation.py")
    mine = findings_for(path, ["threads"])
    ref = findings_for(path, ["threads"], mod=jax_core)
    assert _shape(mine) == _shape(ref) and len(active(mine)) == 3
    assert [f.message for f in active(mine)] == [f.message for f in active(ref)]


def test_serde_checker_matches_jax_on_the_jax_fixtures(monkeypatch):
    structs = os.path.join(JAX_FIXTURES, "serde_structs.py").replace(os.sep, "/")
    frames = os.path.join(JAX_FIXTURES, "serde_violation.py").replace(os.sep, "/")
    for mod in (serde_check, jax_serde):
        monkeypatch.setattr(mod, "SERDE_PATH", frames)
        monkeypatch.setattr(mod, "STRUCT_BINDINGS",
                            ((structs, "Record", "encode_record", "decode_record"),))
        monkeypatch.setattr(mod, "DICT_BINDINGS", ((
            structs, "Gate.snapshot_state", "Gate.restore_state",
            "encode_gate_state", "decode_gate_state"),))
    mine = findings_for([structs, frames], ["serde"])
    ref = findings_for([structs, frames], ["serde"], mod=jax_core)
    assert _shape(mine) == _shape(ref) and len(active(mine)) >= 4


def test_metrics_checker_matches_jax_on_one_perf_md(tmp_path):
    """One dictionary body: in PERF.md for the JAX checker, in the port's
    dictionary module (and repeated in PERF.md) for the port's."""
    for pkg in ("kafkastreams_cep_tpu", "kafkastreams_cep_tpu_torch"):
        d = tmp_path / pkg / "obs"
        d.mkdir(parents=True)
        (d / "registry.py").write_text(
            "def setup(reg):\n"
            '    reg.counter("cep_a_total", "x")\n'
            '    reg.histogram("cep_b_seconds", "y")\n'
            '    reg.gauge("cep_c", "z")\n'
        )
    body = "- `cep_a_total` (ctr)\n- `cep_c{query}` (gauge) · `cep_ghost` (gauge)\n"
    (tmp_path / "kafkastreams_cep_tpu_torch" / "obs" / "metrics_dictionary.py").write_text(
        _dictionary(body))
    (tmp_path / "PERF.md").write_text(
        "<!-- ceplint:metrics-dictionary:begin -->\n" + body
        + "<!-- ceplint:metrics-dictionary:end -->\n\n"
        "<!-- ceplint-torch:metrics-dictionary:begin -->\n" + body
        + "<!-- ceplint-torch:metrics-dictionary:end -->\n")
    mine = findings_for(["kafkastreams_cep_tpu_torch"], ["metrics"], root_dir=str(tmp_path))
    ref = findings_for(["kafkastreams_cep_tpu"], ["metrics"], root_dir=str(tmp_path),
                       mod=jax_core)
    assert sorted((f.code, f.context) for f in active(mine)) == sorted(
        (f.code, f.context) for f in active(ref)) == [
        ("CEP-M01", "metric:cep_b_seconds"), ("CEP-M02", "metric:cep_ghost")]


def _scripted(threading_mod, Monitor):
    """One scripted sequence of lock operations under `Monitor`: a
    consistent pair, an inversion, an RLock re-entered under a Condition,
    and a pair taken on a named thread. Locks are made on fixed lines so
    both monitors see the same sites."""
    mon = Monitor().install()
    try:
        a = threading_mod.Lock()
        b = threading_mod.Lock()
        r = threading_mod.RLock()
        c = threading_mod.Condition()
        with a:
            with b:
                with r:
                    with r:
                        pass
        with c:
            with a:
                pass

        def worker():
            with b:
                with a:
                    pass

        t = threading_mod.Thread(target=worker, name="kct-script")
        t.start()
        t.join()
    finally:
        mon.uninstall()
    return mon


def test_lock_monitors_match_jax_on_scripted_sequences():
    mine = _scripted(threading, LockMonitor)
    ref = _scripted(threading, JaxLockMonitor)
    assert mine.edges == ref.edges and len(mine.edges) >= 4
    assert mine.cycles() == ref.cycles() and mine.cycles()
    assert mine.acquires == ref.acquires
