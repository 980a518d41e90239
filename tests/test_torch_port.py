"""The PyTorch port against the JAX package: imports, config, tables,
expression semantics, and the stock demo golden.

Everything here runs on the CPU: the JAX side is the reference
(`JAX_PLATFORMS=cpu`, eager jnp for expressions), the port side runs its
plain PyTorch code, and the C that ops/codegen.py emits into the step
kernel runs in the kernel source's g++ emulation build. Inputs are made
from fixed seeds and compared bitwise.
"""
import ast
import ctypes
import dataclasses
import os
import random
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import kafkastreams_cep_tpu as J  # noqa: E402
import kafkastreams_cep_tpu_torch as P  # noqa: E402
from kafkastreams_cep_tpu.ops.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from kafkastreams_cep_tpu.ops.schema import EventSchema as JaxEventSchema  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import DeviceEnv  # noqa: E402
from kafkastreams_cep_tpu.ops.tables import compile_query as jax_compile_query  # noqa: E402
from kafkastreams_cep_tpu_torch.models import skip_any  # noqa: E402
from kafkastreams_cep_tpu_torch.models.cases import CASES, STOCK_FIELDS  # noqa: E402
from kafkastreams_cep_tpu_torch.models.stocks import (  # noqa: E402
    GOLDEN_EVENTS, GOLDEN_MATCHES, stocks_pattern,
)
from kafkastreams_cep_tpu_torch.ops import step_kernel as sk  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.codegen import field_layout  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.numerics import TV  # noqa: E402
from kafkastreams_cep_tpu_torch.ops.tables import TorchEnv  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kafkastreams_cep_tpu_torch"


# ------------------------------------------------------------ (a) no JAX
def test_port_import_loads_no_jax():
    code = (
        "import sys, kafkastreams_cep_tpu_torch\n"
        "import kafkastreams_cep_tpu_torch.ops.step_kernel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('kafkastreams_cep_tpu.') or m == 'kafkastreams_cep_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_nothing_of_jax():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "kafkastreams_cep_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert not offenders, offenders


# ------------------------------------------------- (b) config and tables
def test_engine_config_mirrors_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxEngineConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(P.EngineConfig)]
    assert pf == jf
    q_j = jax_compile_query(J.compile_pattern(_jax_skip_any8()), None)
    q_p = P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None)
    for kw in ({}, {"digits": 5}):
        assert P.EngineConfig(**kw).dewey_width(q_p) == JaxEngineConfig(**kw).dewey_width(q_j)
    with pytest.raises(ValueError):
        P.EngineConfig(on_overflow="spill")


def _jax_skip_any8():
    qb = J.QueryBuilder()
    b = qb.select("s0").where(J.value() == "A").within(ms=16)
    for i, ch in enumerate("BCDEFGH", start=1):
        b = (
            b.then().select(f"s{i}", J.Selected.with_skip_til_any_match())
            .where(J.value() == ch).within(ms=16)
        )
    return b.build()


def _query_pairs():
    out = {}
    for name, (pattern, fields, _stream, _cfg) in CASES.items():
        out[name] = (
            jax_compile_query(J.compile_pattern(pattern(J)),
                              JaxEventSchema(fields) if fields else None),
            P.compile_query(P.compile_pattern(pattern()),
                            P.EventSchema(fields) if fields else None),
        )
    out["skip_any8"] = (
        jax_compile_query(J.compile_pattern(_jax_skip_any8()), None),
        P.compile_query(P.compile_pattern(skip_any.skip_any8_pattern()), None),
    )
    from kafkastreams_cep_tpu.models.stocks import stocks_pattern as jax_stocks

    out["stock_golden"] = (
        jax_compile_query(J.compile_pattern(jax_stocks()), JaxEventSchema(STOCK_FIELDS)),
        P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS)),
    )
    return out


TABLE_ARRAYS = (
    "consume_op", "consume_pred", "consume_target", "ignore_pred",
    "proceed_kind", "proceed_pred", "proceed_target", "window_ms", "name_id",
    "pure_name_id", "is_begin", "is_final", "is_fwd", "fwd_final",
    "pred_stateful",
)
TABLE_SCALARS = (
    "n_stages", "n_preds", "n_aggs", "max_depth", "agg_slots", "agg_defaults",
    "name_of_id", "begin_stage",
)


def test_compiled_tables_equal_jax():
    for name, (qj, qp) in _query_pairs().items():
        for attr in TABLE_ARRAYS:
            a, b = getattr(qj, attr), getattr(qp, attr)
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{name}.{attr}"
        for attr in TABLE_SCALARS:
            assert getattr(qj, attr) == getattr(qp, attr), f"{name}.{attr}"
        assert len(qj.predicates) == len(qp.predicates)
        assert [len(f) for f in qj.folds] == [len(f) for f in qp.folds]


# ---------------------------------------------------- (c) expression fuzz
N = 64
REG_NAMES = ("r0", "r1")


def _columns(rng: np.random.Generator):
    a = rng.integers(-50, 50, N).astype(np.int32)
    a[::7] = 0
    a[3] = np.iinfo(np.int32).min
    nz = rng.integers(1, 9, N).astype(np.int32) * rng.choice([-1, 1], N).astype(np.int32)
    x = (rng.standard_normal(N) * 40).astype(np.float32)
    x[5] = 0.0
    y = (rng.uniform(0.5, 9.0, N) * rng.choice([-1, 1], N)).astype(np.float32)
    ts = rng.integers(0, 1 << 20, N).astype(np.int32)
    regs = (rng.standard_normal((N, 2)) * 30).astype(np.float32)
    rset = rng.random((N, 2)) < 0.6
    return {"f:a": a, "f:nz": nz, "f:x": x, "f:y": y, "ts": ts,
            "topic": np.zeros(N, np.int32)}, regs, rset


def _gen(rng: random.Random, depth: int, want: str):
    """A random expression of kind `want` ("num" or "bool")."""
    E = P.pattern.expressions
    if want == "bool":
        if depth <= 0 or rng.random() < 0.5:
            op = rng.choice(["<", "<=", ">", ">=", "==", "!="])
            lhs, rhs = _gen(rng, depth - 1, "num"), _gen(rng, depth - 1, "num")
            return {"<": lhs < rhs, "<=": lhs <= rhs, ">": lhs > rhs,
                    ">=": lhs >= rhs, "==": lhs == rhs, "!=": lhs != rhs}[op]
        k = rng.choice(["and", "or", "not"])
        if k == "not":
            return ~_gen(rng, depth - 1, "bool")
        lhs, rhs = _gen(rng, depth - 1, "bool"), _gen(rng, depth - 1, "bool")
        return (lhs & rhs) if k == "and" else (lhs | rhs)
    if depth <= 0 or rng.random() < 0.3:
        return rng.choice([
            E.field("a"), E.field("nz"), E.field("x"), E.field("y"),
            E.timestamp(), E.agg("r0"), E.agg("r1", default=2.5),
            E.agg("missing", default=3), E.const(rng.randint(-7, 7)),
            E.const(rng.choice([0.8, -2.5, 1e-3, 0.1, 3.0])),
        ])
    op = rng.choice(["+", "-", "*", "/", "//", "%"])
    lhs = _gen(rng, depth - 1, "num")
    if op in ("/", "//", "%"):
        # Divisors that are never zero: a zero float divisor makes a NaN
        # whose payload is not part of jnp's contract.
        rhs = rng.choice([E.field("nz"), E.field("y"), E.const(rng.choice([2, -3, 7])),
                          E.const(rng.choice([0.5, -1.5, 3.25]))])
    else:
        rhs = _gen(rng, depth - 1, "num")
    return {"+": lhs + rhs, "-": lhs - rhs, "*": lhs * rhs, "/": lhs / rhs,
            "//": lhs // rhs, "%": lhs % rhs}[op]


def _as_numpy(v):
    if isinstance(v, TV):
        return v.t.numpy()
    if isinstance(v, (bool, int, float)):
        return v
    return np.asarray(v)


def _same(a, b) -> bool:
    if not isinstance(a, np.ndarray) or not isinstance(b, np.ndarray):
        return type(a) is type(b) and a == b
    if a.dtype != b.dtype:
        return False
    a, b = np.broadcast_arrays(a, b)
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    return np.array_equal(a, b)


def _envs(cols, regs, rset):
    slots = {"r0": 0, "r1": 1}
    defaults = {"r0": 0.0, "r1": 0.0, "missing": 0.0}
    jenv = DeviceEnv({k: jnp.asarray(v) for k, v in cols.items()},
                     jnp.asarray(regs), jnp.asarray(rset), slots, defaults)
    tenv = TorchEnv({k: torch.from_numpy(v) for k, v in cols.items()},
                    torch.from_numpy(np.array(regs)), torch.from_numpy(np.array(rset)),
                    slots, defaults)
    return jenv, tenv


def test_expression_fuzz_matches_eager_jnp():
    rng = random.Random(2024)
    cols, regs, rset = _columns(np.random.default_rng(7))
    jenv, tenv = _envs(cols, regs, rset)
    checked = 0
    for i in range(48):
        expr = _gen(rng, 3, "num" if i % 2 else "bool")
        got_j, got_t = _as_numpy(expr.evaluate(jenv)), _as_numpy(expr.evaluate(tenv))
        assert _same(got_j, got_t), f"{expr!r}: jnp {got_j} vs torch {got_t}"
        checked += 1
    E = P.pattern.expressions
    # Integer // and % against a divisor column holding zeros and INT_MIN
    # (XLA's division: x // 0 == -1 before the floor adjust, x % 0 == 0).
    for expr in (E.field("a") // E.field("nz"), E.field("nz") // E.field("a"),
                 E.field("nz") % E.field("a"), E.field("a") % E.field("nz"),
                 E.field("a") // -1, E.field("a") % -1, 7 // E.field("a"),
                 E.field("a") / E.field("nz"), E.field("x") // 2, E.field("x") % 3):
        assert _same(_as_numpy(expr.evaluate(jenv)), _as_numpy(expr.evaluate(tenv))), repr(expr)
        checked += 1
    assert checked == 58


def test_fold_chain_matches_eager_jnp():
    """A chain of fold updates, each reading the registers the previous
    one wrote, masked per lane (the engine's apply_folds)."""
    E = P.pattern.expressions
    rng = random.Random(99)
    cols, regs, rset = _columns(np.random.default_rng(3))
    folds = [
        (0, E.field("a")), (1, (E.agg("r1", default=0) + E.field("a")) // 2),
        (0, E.agg("r0") * 0.5 + E.field("x")), (1, E.agg("r1") % E.field("y")),
        (0, E.field("x") / E.field("nz") - E.agg("r1", default=1)),
    ] + [(rng.randint(0, 1), _gen(rng, 2, "num")) for _ in range(10)]
    jr, js = jnp.asarray(regs), jnp.asarray(rset)
    tr, ts = torch.from_numpy(regs.copy()), torch.from_numpy(rset.copy())
    nprng = np.random.default_rng(5)
    for slot, expr in folds:
        mask = nprng.random(N) < 0.7
        jenv, tenv = _envs(cols, np.asarray(jr), np.asarray(js))
        jv = jnp.broadcast_to(jnp.asarray(expr.evaluate(jenv), jnp.float32), (N,))
        jr = jr.at[:, slot].set(jnp.where(mask, jv, jr[:, slot]))
        js = js.at[:, slot].set(js[:, slot] | mask)
        tenv = TorchEnv({k: torch.from_numpy(v) for k, v in cols.items()}, tr, ts,
                        {"r0": 0, "r1": 1}, {"r0": 0.0, "r1": 0.0, "missing": 0.0})
        from kafkastreams_cep_tpu_torch.ops.numerics import as_f32

        tv = as_f32(expr.evaluate(tenv), (N,), "cpu")
        m = torch.from_numpy(mask)
        tr = tr.clone()
        ts = ts.clone()
        tr[:, slot] = torch.where(m, tv, tr[:, slot])
        ts[:, slot] = ts[:, slot] | m
        assert _same(np.asarray(jr), tr.numpy()), repr(expr)
        assert np.array_equal(np.asarray(js), ts.numpy())


def _probe_query(stages):
    """A query over the fuzz schema: each stage is (where-predicate,
    [(register, fold expression)])."""
    b = P.QueryBuilder()
    for i, (pred, folds) in enumerate(stages):
        b = (b if i == 0 else b.then()).select(f"s{i}").where(pred)
        for reg, expr in folds:
            b = b.fold(reg, expr)
    fields = {"a": np.int32, "nz": np.int32, "x": np.float32, "y": np.float32}
    return P.compile_query(P.compile_pattern(b.build()), P.EventSchema(fields))


def _fuzz_stages(rng: random.Random, n_stages: int):
    """Stateful predicates (each reads a register, so the kernel computes
    it) and one fold per register per stage, r1's reading r0's new value
    where the generator makes it so."""
    stages = []
    for _ in range(n_stages):
        pred = _gen(rng, 3, "bool")
        while not pred.aggs():
            pred = _gen(rng, 3, "bool")
        stages.append((pred, [(r, _gen(rng, 3, "num")) for r in REG_NAMES]))
    return stages


def _edge_stages():
    """The integer and float division edge cases of the jnp fuzz, as folds
    (an int32 result is exact in the f32 register up to 2^24 and at
    INT_MIN)."""
    E = P.pattern.expressions
    exprs = [E.field("a") // E.field("nz"), E.field("nz") // E.field("a"),
             E.field("nz") % E.field("a"), E.field("a") % E.field("nz"),
             E.field("a") // -1, E.field("a") % -1, 7 // E.field("a"),
             E.field("a") / E.field("nz"), E.field("x") // 2, E.field("x") % 3,
             E.field("x") // E.field("y"), E.field("x") % E.field("y")]
    on = E.agg("r0") > -1e30
    return [(on, [("r0", exprs[i]), ("r1", exprs[i + 1])]) for i in range(0, len(exprs), 2)]


def _probe_c(lib, query, cols, regs, rset, stage):
    """The generated C of `query` on the fuzz columns, through the
    emulation build's expression probe: (predicate bits, regs', rset')."""
    ints, floats = field_layout(query)
    fi = np.ascontiguousarray(np.stack([cols[f"f:{n}"] for n in ints], 1), np.int32)
    ff = np.ascontiguousarray(np.stack([cols[f"f:{n}"] for n in floats], 1), np.float32)
    r = np.ascontiguousarray(regs, np.float32).copy()
    rs = np.ascontiguousarray(rset, np.uint8).copy()
    bits = np.zeros(N, np.uint64)
    ts = np.ascontiguousarray(cols["ts"], np.int32)
    topic = np.ascontiguousarray(cols["topic"], np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    lib.nfa_eval_exprs(ctypes.c_int(N), ctypes.c_int(stage), ptr(ts), ptr(topic), ptr(fi),
                       ptr(ff), ptr(r), ptr(rs), ptr(bits))
    return bits, r, rs.astype(bool)


def test_generated_c_matches_eager_jnp():
    """The C that `CudaEnv` emits into the kernel (ops/codegen.py), built
    under the CPU emulation, against eager jnp on the fuzz columns: every
    stateful predicate, and every stage's fold chain, bitwise."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to compile the kernel source for the CPU")
    queries = [_probe_query(_fuzz_stages(random.Random(seed), 8)) for seed in (11, 12)]
    queries.append(_probe_query(_edge_stages()))
    config = P.EngineConfig(lanes=32, nodes=64, matches=16)
    with ThreadPoolExecutor(len(queries)) as ex:
        paths = list(ex.map(lambda q: sk.build_library(q, config, target="cpu"), queries))
    cols, regs, rset = _columns(np.random.default_rng(17))
    checked = 0
    for query, path in zip(queries, paths):
        lib = ctypes.CDLL(str(path))
        assert query.agg_slots == {"r0": 0, "r1": 1}
        jenv = DeviceEnv({k: jnp.asarray(v) for k, v in cols.items()},
                         jnp.asarray(regs), jnp.asarray(rset),
                         query.agg_slots, query.agg_defaults)
        bits, _, _ = _probe_c(lib, query, cols, regs, rset, stage=-1)
        for p, pred in enumerate(query.predicates):
            if not query.pred_stateful[p]:
                continue
            want = np.broadcast_to(np.asarray(pred(jenv), bool), (N,))
            got = ((bits >> np.uint64(p)) & np.uint64(1)).astype(bool)
            assert np.array_equal(want, got), f"predicate {p}"
            checked += 1
        for cs, stage_folds in enumerate(query.folds):
            if not stage_folds:
                continue
            jr, js = jnp.asarray(regs), jnp.asarray(rset)
            for slot, fn in stage_folds:
                env = DeviceEnv({k: jnp.asarray(v) for k, v in cols.items()}, jr, js,
                                query.agg_slots, query.agg_defaults)
                jv = jnp.broadcast_to(jnp.asarray(fn(env), jnp.float32), (N,))
                jr = jr.at[:, slot].set(jv)
                js = js.at[:, slot].set(True)
                checked += 1
            _, r, rs = _probe_c(lib, query, cols, regs, rset, stage=cs)
            assert _same(np.asarray(jr), r), f"stage {cs} folds"
            assert np.array_equal(np.asarray(js), rs), f"stage {cs} fold flags"
    assert checked == 2 * (8 + 16) + (6 + 12)


# --------------------------------------------------------- (g) stock golden
def test_stock_golden_on_the_port():
    query = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    eng = P.BatchedDeviceNFA(query, keys=["s1", "s2"], device="cpu",
                             config=P.EngineConfig(lanes=32, nodes=512, matches=64))
    got = {"s1": [], "s2": []}
    for i, e in enumerate(GOLDEN_EVENTS):
        ev = P.Event("K", dict(e), 1_000_000 + i, "Stocks", 0, i)
        for key, seqs in eng.advance({"s1": [ev], "s2": [ev]}).items():
            got[key].extend(P.sequence_to_json(s) for s in seqs)
    assert got == {"s1": GOLDEN_MATCHES, "s2": GOLDEN_MATCHES}
    assert all(v == 0 for k, v in eng.stats.items() if k.endswith("_drops"))


def test_no_card_means_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    query = P.compile_query(P.compile_pattern(stocks_pattern()), P.EventSchema(STOCK_FIELDS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.BatchedDeviceNFA(query, keys=["k"])
