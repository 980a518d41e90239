"""Query compiler: Stages -> packed transition tables + traced closures.

The host compiler (pattern/compiler.py) produces the NFA stage graph; this
module lowers it for the device engine (ops/engine.py):

  * per-stage edge slots packed into dense int32 arrays (a stage has at most
    one consuming edge BEGIN|TAKE, one IGNORE, one PROCEED|SKIP_PROCEED --
    guaranteed by the construction rules, StagesFactory.java:101-169);
  * predicates deduplicated into a list of closures evaluated against
    (event columns, fold registers) -- the same closure runs on torch
    tensors (TorchEnv) and emits C for the step kernel (ops/codegen.py
    CudaEnv), instead of the reference's per-edge virtual call
    (NFA.java:371-384);
  * fold updates per stage lowered the same way;
  * stages grouped by (name, type) into buffer-key name ids (the Matched key
    identity, state/internal/Matched.java:21-34);
  * string constants in expressions tokenized via the EventSchema.

The epsilon-PROCEED descent is not a table: the engine unrolls it to the
static stage count (SURVEY.md section 7, "Recursive epsilon-evaluation").
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..pattern.expressions import (
    AggRef,
    BinOp,
    BoolOp,
    Const,
    Env,
    Expr,
    Field,
    Key,
    NotOp,
    Timestamp,
    TopicIs,
    TrueExpr,
    Value,
)
from ..pattern.stages import EdgeOperation, Stage, Stages, StateType
from .numerics import TV
from .schema import EventSchema

# consume ops
OP_NONE, OP_BEGIN, OP_TAKE = 0, 1, 2
# proceed kinds
PR_NONE, PR_PROCEED, PR_SKIP = 0, 1, 2


class TorchEnv(Env):
    """Expression environment over torch columns + per-run registers.

    The port's counterpart of the JAX package's `DeviceEnv`: `event` maps
    column names to tensors that broadcast against the register planes
    (`regs[..., slot]`), and every value is wrapped in `TV` so the closures'
    Python operators follow jnp's promotion and division rules
    (ops/numerics.py).
    """

    def __init__(
        self,
        event: Dict[str, Any],
        regs: Any,
        regs_set: Any,
        agg_slots: Dict[str, int],
        defaults: Dict[str, float],
    ) -> None:
        self._event = event
        self._regs = regs
        self._regs_set = regs_set
        self._agg_slots = agg_slots
        self._defaults = defaults

    def field(self, name: str) -> Any:
        return TV(self._event[f"f:{name}"])

    def value(self) -> Any:
        return TV(self._event["f:"])

    def key(self) -> Any:
        raise NotImplementedError("key() is not available in device predicates")

    def timestamp(self) -> Any:
        return TV(self._event["ts"])

    def topic_is(self, topic_code: Any) -> Any:
        return TV(self._event["topic"] == topic_code)

    def agg(self, name: str, default: Any = None) -> Any:
        slot = self._agg_slots.get(name)
        fallback = default if default is not None else self._defaults.get(name, 0)
        fb = torch.tensor(fallback, dtype=torch.float32, device=self._regs.device)
        if slot is None:
            # No fold ever writes this register: the read is the constant.
            return TV(fb)
        return TV(torch.where(self._regs_set[..., slot], self._regs[..., slot], fb))

    def true(self) -> Any:
        return True


def _encode_consts(expr: Expr, schema: EventSchema) -> Expr:
    """Rebuild the tree with string constants tokenized for the device."""
    if isinstance(expr, Const):
        return Const(schema.encode_const(expr.value))
    if isinstance(expr, TopicIs):
        return TopicIs(schema.topic_id(expr.topic))  # type: ignore[arg-type]
    if isinstance(expr, BinOp):
        return BinOp(
            _encode_consts(expr.left, schema), _encode_consts(expr.right, schema),
            expr.op, expr.sym,
        )
    if isinstance(expr, BoolOp):
        return BoolOp(
            _encode_consts(expr.left, schema), _encode_consts(expr.right, schema), expr.kind
        )
    if isinstance(expr, NotOp):
        return NotOp(_encode_consts(expr.inner, schema))
    return expr


@dataclass
class CompiledQuery:
    """Device-ready form of one compiled pattern query."""

    schema: EventSchema
    n_stages: int
    n_preds: int
    n_aggs: int
    max_depth: int  # epsilon-chain unroll depth

    # Per-stage tables, shape [S] (numpy; moved to device by the engine).
    consume_op: np.ndarray      # OP_NONE | OP_BEGIN | OP_TAKE
    consume_pred: np.ndarray    # predicate id (-1 none)
    consume_target: np.ndarray  # target stage id (-1 none)
    ignore_pred: np.ndarray     # predicate id (-1 none)
    proceed_kind: np.ndarray    # PR_NONE | PR_PROCEED | PR_SKIP
    proceed_pred: np.ndarray
    proceed_target: np.ndarray
    window_ms: np.ndarray       # i64, -1 none (int64 so >24.8-day windows
                                # don't overflow)
    name_id: np.ndarray         # buffer-key identity (name, type) id
    pure_name_id: np.ndarray    # name-only id (stage-cross detection,
                                # NFA.java:343-349 compares getName())
    is_begin: np.ndarray        # bool
    is_final: np.ndarray        # bool
    #: stage is a pure forwarder: single PROCEED edge
    #: (ComputationStage.isForwarding, ComputationStage.java:134-140)
    is_fwd: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, bool))
    #: forwarding stage whose PROCEED target is $final
    fwd_final: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, bool))
    #: per-predicate: reads fold registers (must be evaluated per run lane)
    pred_stateful: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, bool))

    #: predicate closures: fn(env) -> bool mask broadcast over runs
    predicates: List[Callable[[Env], Any]] = dc_field(default_factory=list)
    #: per stage: list of (agg slot, update closure fn(env) -> value)
    folds: List[List[Tuple[int, Callable]]] = dc_field(default_factory=list)
    agg_slots: Dict[str, int] = dc_field(default_factory=dict)
    agg_defaults: Dict[str, float] = dc_field(default_factory=dict)
    name_of_id: List[str] = dc_field(default_factory=list)
    begin_stage: int = 0
    #: the host stage graph this query was lowered from, retained so the
    #: exact-replay path (ops/replay.py) can rebuild a host oracle and the
    #: device stage ids map back to Stage objects (stage_list[i]).
    host_stages: Optional[Stages] = None
    stage_list: List[Stage] = dc_field(default_factory=list)
    #: multi-query stacking (compile_multi_query): one begin lane per
    #: stacked query, and per-name-id query attribution for match routing.
    #: None for ordinary single-query compiles.
    begin_stages: Optional[List[int]] = None
    qid_of_name_id: Optional[np.ndarray] = None
    query_names: Optional[List[str]] = None


def compile_query(stages: Stages, schema: Optional[EventSchema] = None) -> CompiledQuery:
    """Lower a compiled stage graph into device tables.

    Requires every predicate and fold to be expression-based
    (device_compilable); raises ValueError otherwise with the offending
    stage named, directing users to the host path.
    """
    schema = schema if schema is not None else EventSchema()
    stage_list: List[Stage] = list(stages)
    n = len(stage_list)
    index_of = {id(s): i for i, s in enumerate(stage_list)}

    consume_op = np.zeros(n, np.int32)
    consume_pred = np.full(n, -1, np.int32)
    consume_target = np.full(n, -1, np.int32)
    ignore_pred = np.full(n, -1, np.int32)
    proceed_kind = np.zeros(n, np.int32)
    proceed_pred = np.full(n, -1, np.int32)
    proceed_target = np.full(n, -1, np.int32)
    window_ms = np.full(n, -1, np.int64)
    name_id = np.zeros(n, np.int32)
    pure_name_id = np.zeros(n, np.int32)
    is_begin = np.zeros(n, bool)
    is_final = np.zeros(n, bool)

    predicates: List[Callable] = []
    pred_stateful: List[bool] = []
    pred_ids: Dict[int, int] = {}
    name_ids: Dict[Tuple[str, StateType], int] = {}
    name_of_id: List[str] = []
    pure_name_ids: Dict[str, int] = {}
    agg_slots: Dict[str, int] = {}
    agg_defaults: Dict[str, float] = {}
    folds: List[List[Tuple[int, Callable]]] = [[] for _ in range(n)]

    def pred_id(predicate) -> int:
        key = id(predicate)
        got = pred_ids.get(key)
        if got is not None:
            return got
        expr = predicate.expr()
        if expr is None:
            raise ValueError(
                "predicate is not device-compilable (closure-based); use "
                "expression predicates (field()/agg()/value()) or the host path"
            )
        stateful = bool(expr.aggs())
        expr = _encode_consts(expr, schema)
        pid = len(predicates)

        def run(env: Env, _e=expr) -> Any:
            return _e.evaluate(env)

        predicates.append(run)
        pred_stateful.append(stateful)
        pred_ids[key] = pid
        return pid

    begin_stage = -1
    for i, stage in enumerate(stage_list):
        key = (stage.name, stage.type)
        if key not in name_ids:
            name_ids[key] = len(name_of_id)
            name_of_id.append(stage.name)
        name_id[i] = name_ids[key]
        if stage.name not in pure_name_ids:
            pure_name_ids[stage.name] = len(pure_name_ids)
        pure_name_id[i] = pure_name_ids[stage.name]
        window_ms[i] = stage.window_ms
        is_begin[i] = stage.is_begin
        is_final[i] = stage.is_final
        if stage.is_begin and begin_stage < 0:
            begin_stage = i

        for aggregator in stage.aggregates:
            if aggregator.name not in agg_slots:
                agg_slots[aggregator.name] = len(agg_slots)
                agg_defaults[aggregator.name] = (
                    float(aggregator.initial) if aggregator.initial is not None else 0.0
                )
            if aggregator.expression is None:
                raise ValueError(
                    f"fold {aggregator.name!r} on stage {stage.name!r} is not "
                    "device-compilable (callable-based); use expression folds"
                )
            expr = _encode_consts(aggregator.expression, schema)
            slot = agg_slots[aggregator.name]

            def update(env: Env, _e=expr) -> Any:
                return _e.evaluate(env)

            folds[i].append((slot, update))

        for edge in stage.edges:
            op = edge.operation
            if op in (EdgeOperation.BEGIN, EdgeOperation.TAKE):
                consume_op[i] = OP_BEGIN if op == EdgeOperation.BEGIN else OP_TAKE
                consume_pred[i] = pred_id(edge.predicate)
                consume_target[i] = index_of[id(edge.target)]
            elif op == EdgeOperation.IGNORE:
                ignore_pred[i] = pred_id(edge.predicate)
            else:
                proceed_kind[i] = (
                    PR_PROCEED if op == EdgeOperation.PROCEED else PR_SKIP
                )
                proceed_pred[i] = pred_id(edge.predicate)
                proceed_target[i] = index_of[id(edge.target)]

    # A stage is a pure forwarder iff its only edge is a PROCEED
    # (ComputationStage.isForwarding); runtime epsilon states are forwarders
    # by construction, so depth below bounds the live descent chain.
    is_fwd = (
        (consume_op == OP_NONE) & (ignore_pred < 0) & (proceed_kind == PR_PROCEED)
    )
    fwd_final = np.zeros(n, bool)
    for i in range(n):
        if is_fwd[i] and proceed_target[i] >= 0:
            fwd_final[i] = bool(is_final[proceed_target[i]])

    # Epsilon-descent unroll depth: 1 level for the run's own (possibly
    # synthesized-epsilon) stage plus the longest static PROCEED/SKIP_PROCEED
    # chain reachable from any stage (SURVEY.md section 7, "Recursive
    # epsilon-evaluation": max depth is static).
    chain = [0] * n
    def _chain(i: int, seen: Tuple[int, ...] = ()) -> int:
        if proceed_kind[i] == PR_NONE or proceed_target[i] < 0:
            return 1
        tgt = int(proceed_target[i])
        if tgt in seen:  # defensive: construction rules never build cycles
            return 1
        return 1 + _chain(tgt, seen + (i,))
    for i in range(n):
        chain[i] = _chain(i)
    max_depth = 1 + max(chain) if n else 1

    return CompiledQuery(
        schema=schema,
        n_stages=n,
        n_preds=len(predicates),
        n_aggs=max(1, len(agg_slots)),
        max_depth=max_depth,
        consume_op=consume_op,
        consume_pred=consume_pred,
        consume_target=consume_target,
        ignore_pred=ignore_pred,
        proceed_kind=proceed_kind,
        proceed_pred=proceed_pred,
        proceed_target=proceed_target,
        window_ms=window_ms,
        name_id=name_id,
        pure_name_id=pure_name_id,
        is_begin=is_begin,
        is_final=is_final,
        is_fwd=is_fwd,
        fwd_final=fwd_final,
        pred_stateful=np.asarray(pred_stateful, bool),
        predicates=predicates,
        folds=folds,
        agg_slots=agg_slots,
        agg_defaults=agg_defaults,
        name_of_id=name_of_id,
        begin_stage=begin_stage,
        host_stages=stages,
        stage_list=stage_list,
    )


def compile_multi_query(
    named_queries: List[Tuple[str, Any]],
    schema: Optional[EventSchema] = None,
) -> CompiledQuery:
    """Stack Q compiled queries into ONE device table set (SURVEY.md §2.8
    "multiple concurrent queries = stacked transition tables").

    The reference runs N independent processor nodes over one topic
    (reference: core/.../kstream/internals/CEPStreamImpl.java:80-93), so N
    queries cost N per-record NFA walks. Here the per-query stage tables
    concatenate with offset stage/predicate/name/register ids, one begin
    lane per query seeds the shared lane pool, and a single device advance
    serves every query -- the event columns are packed once and the kernel's
    unrolled lookups span the union stage table.

    All queries must share one event schema (they observe the same packed
    columns -- pass `schema`, or let one be created here); aggregate fold
    names must be distinct across queries (each register slot is one fold
    cell; a cross-query name collision raises). Match routing back to the
    owning query rides `qid_of_name_id` (chains never span queries).
    """
    from ..pattern.compiler import compile_pattern as _compile_pattern
    from ..pattern.pattern import Pattern

    if not named_queries:
        raise ValueError("compile_multi_query needs at least one query")
    shared_schema = schema if schema is not None else EventSchema()
    names: List[str] = []
    compiled: List[CompiledQuery] = []
    for qname, q in named_queries:
        names.append(str(qname))
        if isinstance(q, CompiledQuery):
            if q.schema is not shared_schema:
                raise ValueError(
                    "stacked CompiledQuery must be compiled against the "
                    "shared schema object (pass Stages/Pattern instead)"
                )
            compiled.append(q)
        elif isinstance(q, Stages):
            compiled.append(compile_query(q, shared_schema))
        elif isinstance(q, Pattern):
            compiled.append(compile_query(_compile_pattern(q), shared_schema))
        else:
            raise TypeError(f"cannot stack {type(q).__name__}")

    agg_slots: Dict[str, int] = {}
    agg_defaults: Dict[str, float] = {}
    predicates: List[Callable] = []
    pred_stateful: List[bool] = []
    name_of_id: List[str] = []
    qid_of_name: List[int] = []
    folds: List[List[Tuple[int, Callable]]] = []
    begin_stages: List[int] = []
    stage_list: List[Stage] = []

    tabs: Dict[str, List[np.ndarray]] = {
        k: []
        for k in (
            "consume_op", "consume_pred", "consume_target", "ignore_pred",
            "proceed_kind", "proceed_pred", "proceed_target", "window_ms",
            "name_id", "pure_name_id", "is_begin", "is_final", "is_fwd",
            "fwd_final",
        )
    }
    stage_off = 0
    pure_off = 0
    for qi, cq in enumerate(compiled):
        pred_off = len(predicates)
        name_off = len(name_of_id)
        agg_off = len(agg_slots)

        def off_ids(t: np.ndarray, off: int) -> np.ndarray:
            return np.where(t >= 0, t + off, t).astype(t.dtype)

        tabs["consume_op"].append(cq.consume_op)
        tabs["consume_pred"].append(off_ids(cq.consume_pred, pred_off))
        tabs["consume_target"].append(off_ids(cq.consume_target, stage_off))
        tabs["ignore_pred"].append(off_ids(cq.ignore_pred, pred_off))
        tabs["proceed_kind"].append(cq.proceed_kind)
        tabs["proceed_pred"].append(off_ids(cq.proceed_pred, pred_off))
        tabs["proceed_target"].append(off_ids(cq.proceed_target, stage_off))
        tabs["window_ms"].append(cq.window_ms)
        tabs["name_id"].append(cq.name_id + name_off)
        tabs["pure_name_id"].append(cq.pure_name_id + pure_off)
        tabs["is_begin"].append(cq.is_begin)
        tabs["is_final"].append(cq.is_final)
        tabs["is_fwd"].append(cq.is_fwd)
        tabs["fwd_final"].append(cq.fwd_final)

        predicates.extend(cq.predicates)
        pred_stateful.extend(bool(b) for b in cq.pred_stateful)
        name_of_id.extend(cq.name_of_id)
        qid_of_name.extend([qi] * len(cq.name_of_id))
        for agg_name, slot in cq.agg_slots.items():
            if agg_name in agg_slots:
                raise ValueError(
                    f"aggregate name {agg_name!r} appears in more than one "
                    "stacked query; fold registers are per-name cells -- "
                    "rename the fold in one of the queries"
                )
            agg_slots[agg_name] = agg_off + slot
            agg_defaults[agg_name] = cq.agg_defaults.get(agg_name, 0.0)
        for stage_folds in cq.folds:
            folds.append([(agg_off + slot, fn) for slot, fn in stage_folds])
        begin_stages.append(stage_off + cq.begin_stage)
        stage_list.extend(cq.stage_list)

        stage_off += cq.n_stages
        pure_off += int(cq.pure_name_id.max()) + 1 if cq.n_stages else 0

    return CompiledQuery(
        schema=shared_schema,
        n_stages=stage_off,
        n_preds=len(predicates),
        n_aggs=max(1, len(agg_slots)),
        max_depth=max(cq.max_depth for cq in compiled),
        consume_op=np.concatenate(tabs["consume_op"]),
        consume_pred=np.concatenate(tabs["consume_pred"]),
        consume_target=np.concatenate(tabs["consume_target"]),
        ignore_pred=np.concatenate(tabs["ignore_pred"]),
        proceed_kind=np.concatenate(tabs["proceed_kind"]),
        proceed_pred=np.concatenate(tabs["proceed_pred"]),
        proceed_target=np.concatenate(tabs["proceed_target"]),
        window_ms=np.concatenate(tabs["window_ms"]),
        name_id=np.concatenate(tabs["name_id"]),
        pure_name_id=np.concatenate(tabs["pure_name_id"]),
        is_begin=np.concatenate(tabs["is_begin"]),
        is_final=np.concatenate(tabs["is_final"]),
        is_fwd=np.concatenate(tabs["is_fwd"]),
        fwd_final=np.concatenate(tabs["fwd_final"]),
        pred_stateful=np.asarray(pred_stateful, bool),
        predicates=predicates,
        folds=folds,
        agg_slots=agg_slots,
        agg_defaults=agg_defaults,
        name_of_id=name_of_id,
        begin_stage=begin_stages[0],
        # Exact-replay needs ONE host stage graph; a stacked query keeps
        # detection-only semantics (ops/replay.py supports_replay -> False).
        host_stages=None,
        stage_list=stage_list,
        begin_stages=begin_stages,
        qid_of_name_id=np.asarray(qid_of_name, np.int32),
        query_names=names,
    )
