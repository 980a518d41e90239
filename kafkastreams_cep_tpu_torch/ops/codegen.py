"""Per-query C source for the CUDA step kernel.

The Pallas kernel bakes a query's stage tables in as unrolled selects and
traces its predicate and fold closures at build time. The CUDA kernel
(csrc/nfa_step.cu) gets the same per-query specialization from this
module, which writes the header the kernel includes ("nfa_query.cuh"):

  * the sizes (lanes, Dewey digits, registers, descent depth, caps, the
    xi column layout) as compile-time constants, so every per-lane array
    is unrolled into registers;
  * the stage tables the kernel indexes by stage id (targets, windows,
    names) as one `__constant__` array, which the kernel copies to shared
    memory at block start, and every yes/no fact about a stage (its
    consume op, proceed kind, begin/final flags, and which predicate each
    edge tests) as 64-bit stage masks, bit s for stage s, which the
    descent tests in registers -- past 64 stages or 64 predicates (a
    stacked query) each mask is a `Mask<W>` of W 64-bit words instead
    (`wide_masks`);
  * the stateful predicates and the fold updates as C, emitted by running
    the query's own closures against `CudaEnv`: its accessors return
    `CExpr` values whose Python operators build C expressions under jnp's
    promotion rules (ops/numerics.py `result_kind`), so the kernel
    computes what the plain PyTorch version and the JAX package compute.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from ..pattern.expressions import Env
from .engine import EngineConfig, node_window_cap, window_ms_i32
from .numerics import result_kind, scalar_kind
from .step import flat_folds
from .tables import OP_NONE, OP_TAKE, PR_PROCEED, PR_SKIP, CompiledQuery

_C_TYPE = {"b": "bool", "i": "int", "f": "float"}

#: xi columns ahead of the int fields: ts, topic, gidx, valid, wm.
XI_FIXED = ("ts", "topic", "gidx", "valid", "wm")


def c_literal(v: Any, kind: str) -> str:
    """A Python scalar as a C literal of `kind` (jnp's weak-scalar cast)."""
    if kind == "b":
        return "true" if bool(v) else "false"
    if kind == "i":
        iv = int(v)
        if not -(2**31) <= iv < 2**31:
            raise OverflowError(f"constant {v!r} does not fit int32")
        return "INT_MIN" if iv == -(2**31) else f"({iv})"
    f = np.float32(v)
    if math.isnan(f):
        return "(__int_as_float(0x7fc00000))"
    if math.isinf(f):
        return "(1.0f / 0.0f)" if f > 0 else "(-1.0f / 0.0f)"
    return f"({float(f).hex()}f)"


def _convert(code: str, src: str, dst: str) -> str:
    if src == dst:
        return code
    if dst == "b":
        return f"({code} != 0)"
    return f"(({_C_TYPE[dst]})({code}))"


class CExpr:
    """A typed C expression; operators promote the way jnp does."""

    __slots__ = ("code", "kind")

    def __init__(self, code: str, kind: str) -> None:
        self.code = code
        self.kind = kind

    @staticmethod
    def _kind(v: Any) -> str:
        return v.kind if isinstance(v, CExpr) else scalar_kind(v)

    @staticmethod
    def _as(v: Any, kind: str) -> str:
        if isinstance(v, CExpr):
            return _convert(v.code, v.kind, kind)
        return c_literal(v, kind)

    def _operands(self, other: Any, reflected: bool, kind: str):
        a, b = (other, self) if reflected else (self, other)
        return self._as(a, kind), self._as(b, kind)

    def _arith(self, other: Any, reflected: bool, sym: str, int_fn: str) -> "CExpr":
        kind = result_kind(self.kind, self._kind(other))
        if kind == "b":
            raise TypeError("arithmetic on booleans is not supported")
        a, b = self._operands(other, reflected, kind)
        if kind == "i":
            return CExpr(f"{int_fn}({a}, {b})", "i")
        return CExpr(f"({a} {sym} {b})", "f")

    def _divide(self, other: Any, reflected: bool, int_fn: str, float_fn: str) -> "CExpr":
        kind = result_kind(self.kind, self._kind(other))
        if kind == "b":
            raise TypeError("arithmetic on booleans is not supported")
        a, b = self._operands(other, reflected, kind)
        return CExpr(f"{int_fn if kind == 'i' else float_fn}({a}, {b})", kind)

    def _compare(self, other: Any, sym: str) -> "CExpr":
        kind = result_kind(self.kind, self._kind(other))
        a, b = self._operands(other, False, kind)
        return CExpr(f"({a} {sym} {b})", "b")

    def _logic(self, other: Any, sym: str) -> "CExpr":
        if result_kind(self.kind, self._kind(other)) != "b":
            raise TypeError("& and | combine boolean predicates only")
        a, b = self._operands(other, False, "b")
        return CExpr(f"({a} {sym} {b})", "b")

    def __add__(self, o): return self._arith(o, False, "+", "jadd_i")
    def __radd__(self, o): return self._arith(o, True, "+", "jadd_i")
    def __sub__(self, o): return self._arith(o, False, "-", "jsub_i")
    def __rsub__(self, o): return self._arith(o, True, "-", "jsub_i")
    def __mul__(self, o): return self._arith(o, False, "*", "jmul_i")
    def __rmul__(self, o): return self._arith(o, True, "*", "jmul_i")

    def _truediv(self, other: Any, reflected: bool) -> "CExpr":
        a, b = self._operands(other, reflected, "f")
        return CExpr(f"({a} / {b})", "f")

    def __truediv__(self, o): return self._truediv(o, False)
    def __rtruediv__(self, o): return self._truediv(o, True)
    def __floordiv__(self, o): return self._divide(o, False, "jfloordiv_i", "jfloordiv_f")
    def __rfloordiv__(self, o): return self._divide(o, True, "jfloordiv_i", "jfloordiv_f")
    def __mod__(self, o): return self._divide(o, False, "jmod_i", "jmod_f")
    def __rmod__(self, o): return self._divide(o, True, "jmod_i", "jmod_f")

    def __gt__(self, o): return self._compare(o, ">")
    def __ge__(self, o): return self._compare(o, ">=")
    def __lt__(self, o): return self._compare(o, "<")
    def __le__(self, o): return self._compare(o, "<=")
    def __eq__(self, o): return self._compare(o, "==")  # type: ignore[override]
    def __ne__(self, o): return self._compare(o, "!=")  # type: ignore[override]

    def __and__(self, o): return self._logic(o, "&&")
    def __rand__(self, o): return self._logic(o, "&&")
    def __or__(self, o): return self._logic(o, "||")
    def __ror__(self, o): return self._logic(o, "||")

    def __invert__(self) -> "CExpr":
        if self.kind == "b":
            return CExpr(f"(!{self.code})", "b")
        if self.kind == "i":
            return CExpr(f"(~{self.code})", "i")
        raise TypeError("~ is not defined on floats")

    __hash__ = object.__hash__


def as_bool_code(v: Any) -> str:
    """`jnp.asarray(v, bool)` as C."""
    if isinstance(v, CExpr):
        return _convert(v.code, v.kind, "b")
    return c_literal(v, "b")


def as_float_code(v: Any) -> str:
    """`jnp.asarray(v, jnp.float32)` as C."""
    if isinstance(v, CExpr):
        if v.kind == "b":
            return f"({v.code} ? 1.0f : 0.0f)"
        return _convert(v.code, v.kind, "f")
    return c_literal(v, "f")


class CudaEnv(Env):
    """Expression environment that evaluates to C: the event is the
    kernel's `ev` (ts, topic, int fields `fi[]`, float fields `ff[]`) and
    the registers are the lane's `regs[]` / `rset[]`."""

    def __init__(self, query: CompiledQuery) -> None:
        self._query = query
        self._slots: Dict[str, CExpr] = {}
        ni = nf = 0
        for name, dt in query.schema.fields.items():
            if np.dtype(dt) == np.dtype(np.float32):
                self._slots[name] = CExpr(f"ev.ff[{nf}]", "f")
                nf += 1
            elif np.dtype(dt) == np.dtype(np.int32):
                self._slots[name] = CExpr(f"ev.fi[{ni}]", "i")
                ni += 1
            else:
                raise TypeError(f"field {name!r}: only int32/float32 columns are supported")

    def field(self, name: str) -> Any:
        return self._slots[name]

    def value(self) -> Any:
        return self._slots[""]

    def key(self) -> Any:
        raise NotImplementedError("key() is not available in device predicates")

    def timestamp(self) -> Any:
        return CExpr("ev.ts", "i")

    def topic_is(self, topic_code: Any) -> Any:
        return CExpr(f"(ev.topic == {c_literal(topic_code, 'i')})", "b")

    def agg(self, name: str, default: Any = None) -> Any:
        slot = self._query.agg_slots.get(name)
        fallback = default if default is not None else self._query.agg_defaults.get(name, 0)
        fb = c_literal(fallback, "f")
        if slot is None:
            return CExpr(fb, "f")
        return CExpr(f"(rset[{slot}] ? regs[{slot}] : {fb})", "f")

    def true(self) -> Any:
        return True


def field_layout(query: CompiledQuery):
    """(int field names, float field names) in schema order."""
    ints: List[str] = []
    floats: List[str] = []
    for name, dt in query.schema.fields.items():
        (floats if np.dtype(dt) == np.dtype(np.float32) else ints).append(name)
    return ints, floats


def stage_tables(query: CompiledQuery) -> np.ndarray:
    """The per-stage rows the kernel looks up by stage id, in nfa_step.cu's
    TB_* order."""
    rows = [query.consume_target, query.proceed_target, window_ms_i32(query),
            query.name_id, query.pure_name_id]
    return np.stack([np.asarray(r).astype(np.int64) for r in rows]).astype(np.int32)


def _mask(flags) -> int:
    return sum(1 << s for s, f in enumerate(np.asarray(flags)) if f)


def stage_masks(query: CompiledQuery) -> Dict[str, int]:
    """The per-stage yes/no facts as masks over stages (bit s: stage s)."""
    pure_of_ptgt = query.pure_name_id[query.proceed_target.clip(0)]
    isfin_of_ctgt = query.is_final[query.consume_target.clip(0)] & (query.consume_target >= 0)
    return {
        "M_COP_ANY": _mask(query.consume_op != OP_NONE),
        "M_COP_TAKE": _mask(query.consume_op == OP_TAKE),
        "M_PK_PROCEED": _mask(query.proceed_kind == PR_PROCEED),
        "M_PK_SKIP": _mask(query.proceed_kind == PR_SKIP),
        "M_IS_BEGIN": _mask(query.is_begin), "M_IS_FINAL": _mask(query.is_final),
        "M_IS_FWD": _mask(query.is_fwd), "M_FWD_FINAL": _mask(query.fwd_final),
        "M_ISFIN_CTGT": _mask(isfin_of_ctgt),
        "M_PURE_DIFF": _mask(pure_of_ptgt != query.pure_name_id),
    }


def predicate_stages(query: CompiledQuery, p: int) -> Dict[str, int]:
    """The stages whose consume / ignore / proceed edge tests predicate p."""
    return {"cons": _mask(query.consume_pred == p), "ign": _mask(query.ignore_pred == p),
            "proc": _mask(query.proceed_pred == p)}


def wide_masks(query: CompiledQuery) -> bool:
    """Whether the query needs multi-word stage or predicate masks: the
    kernel's NFA_WIDE_MASKS blocks (ops/step_kernel.py resolves them)."""
    return query.n_stages > 64 or query.n_preds > 64


def mask_words(n: int) -> int:
    """64-bit words of a mask over n ids (at least one)."""
    return max(1, -(-n // 64))


def _word(mask: int, i: int) -> int:
    """64-bit word i of a mask."""
    return (mask >> (64 * i)) & ((1 << 64) - 1)


def _mask_literal(type_name: str, mask: int, n_words: int) -> str:
    words = ", ".join(f"{_word(mask, i):#x}ull" for i in range(n_words))
    return f"({type_name}{{{{{words}}}}})"


#: The multi-word mask of the wide header: W words in registers, a word
#: read by selects (no local memory), `&` word by word.
_MASK_TYPE = """template <int W>
struct Mask {
  unsigned long long w[W];
  __device__ __forceinline__ unsigned long long word(int i) const {
    unsigned long long v = w[0];
#pragma unroll
    for (int j = 1; j < W; ++j) v = i == j ? w[j] : v;
    return v;
  }
  __device__ __forceinline__ bool bit(int i) const { return (word(i >> 6) >> (i & 63)) & 1ull; }
};
template <int W>
__device__ __forceinline__ Mask<W> operator&(const Mask<W>& a, const Mask<W>& b) {
  Mask<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = a.w[j] & b.w[j];
  return r;
}
using SMask = Mask<SW>;
using PMask = Mask<PW>;
"""


def query_header(query: CompiledQuery, config: EngineConfig) -> str:
    """The generated "nfa_query.cuh" for one (query, config). A query of
    at most 64 stages and 64 predicates gets single-word masks (the
    header it always had); a wider one gets `Mask<W>` masks."""
    P = query.n_preds
    wide = wide_masks(query)
    SW, PW = mask_words(len(query.consume_op)), mask_words(P)
    ints, floats = field_layout(query)
    env = CudaEnv(query)
    tab = stage_tables(query)
    stateless = 0
    for p in range(P):
        if not query.pred_stateful[p]:
            stateless |= 1 << p
    lines = [
        "// Generated by ops/codegen.py for one compiled query; do not edit.",
        f"constexpr int R = {config.lanes};",
        f"constexpr int D = {config.dewey_width(query)};",
        f"constexpr int A = {query.n_aggs};",
        f"constexpr int L = {query.max_depth};",
        f"constexpr int N_ST = {len(query.consume_op)};",
        f"constexpr int P_CAP = {node_window_cap(query, config)};",
        f"constexpr int M_STEP = {config.matches_per_step};",
        f"constexpr int B_NODES = {config.nodes};",
        f"constexpr int NP = {P};",
        f"constexpr int NI = {len(ints)};",
        f"constexpr int NF = {len(floats)};",
        "constexpr int XI_TS = 0, XI_TOPIC = 1, XI_GIDX = 2, XI_VALID = 3, XI_WM = 4;",
        f"constexpr int XI_FIELDS = {len(XI_FIXED)};",
        "constexpr int XI_SPRED = XI_FIELDS + NI;",
        "constexpr int CI = XI_SPRED + NP;",
    ]
    if wide:
        lines += [f"constexpr int SW = {SW}, PW = {PW};", _MASK_TYPE.rstrip("\n"),
                  f"#define STATELESS_MASK {_mask_literal('PMask', stateless, PW)}"]
    else:
        lines.append(f"constexpr unsigned long long STATELESS_MASK = {stateless:#x}ull;")
    lines += [
        f"#define STRICT_WINDOWS {1 if config.strict_windows else 0}",
        f"#define HAS_FOLDS {1 if flat_folds(query) else 0}",
        "__constant__ int c_tab[N_TAB][N_ST] = {",
    ]
    for row in tab:
        lines.append("  {" + ", ".join(str(int(v)) for v in row) + "},")
    lines.append("};")
    for name, m in stage_masks(query).items():
        if wide:
            lines.append(f"#define {name} {_mask_literal('SMask', m, SW)}")
        else:
            lines.append(f"constexpr unsigned long long {name} = {m:#x}ull;")
    lines += [
        "// The stages whose consume / ignore / proceed predicate is among `bits`.",
        "__device__ __forceinline__ void stages_on("
        + ("const PMask& bits," if wide else "unsigned long long bits,"),
        "    SMask& cons, SMask& ign, SMask& proc) {" if wide else
        "    unsigned long long& cons, unsigned long long& ign, unsigned long long& proc) {",
    ]
    for p in range(P):
        if wide:
            sets = [f"{var}.w[{i}] |= {_word(m, i):#x}ull;"
                    for var, m in predicate_stages(query, p).items()
                    for i in range(SW) if _word(m, i)]
            if sets:
                lines.append(f"  if ((bits.w[{p >> 6}] >> {p & 63}) & 1ull) {{ {' '.join(sets)} }}")
            continue
        sets = [f"{var} |= {m:#x}ull;" for var, m in predicate_stages(query, p).items() if m]
        if sets:
            lines.append(f"  if ((bits >> {p}) & 1ull) {{ {' '.join(sets)} }}")
    lines += [
        "  (void)bits; (void)cons; (void)ign; (void)proc;",
        "}",
    ]
    lines += [
        "struct Ev {",
        "  int ts;",
        "  int topic;",
        "  int fi[NI > 0 ? NI : 1];",
        "  float ff[NF > 0 ? NF : 1];",
        "};",
        "// Stateful predicates against the lane's event-start registers.",
        f"__device__ __forceinline__ {'PMask' if wide else 'unsigned long long'} stateful_pred_bits(",
        "    const Ev& ev, const float* regs, const bool* rset) {",
        "  PMask bits = {};" if wide else "  unsigned long long bits = 0;",
    ]
    for p in range(P):
        if query.pred_stateful[p]:
            code = as_bool_code(query.predicates[p](env))
            cond = code if code.startswith('(') else '(' + code + ')'
            if wide:
                lines.append(f"  if {cond} bits.w[{p >> 6}] |= 1ull << {p & 63};")
            else:
                lines.append(f"  if {cond} bits |= 1ull << {p};")
    lines += [
        "  return bits;",
        "}",
        "// Fold updates of one descent level, in per-stage order.",
        "__device__ __forceinline__ void apply_folds(",
        "    const Ev& ev, bool c_m, int cs, float* regs, bool* rset) {",
    ]
    for stage_i, slot, fn in flat_folds(query):
        code = as_float_code(fn(env))
        lines.append(
            f"  if (c_m && cs == {stage_i}) {{ const float v = {code}; "
            f"regs[{slot}] = v; rset[{slot}] = true; }}"
        )
    lines += [
        "  (void)ev; (void)c_m; (void)cs; (void)regs; (void)rset;",
        "}",
    ]
    return "\n".join(lines) + "\n"
