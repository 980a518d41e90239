"""Pattern -> NFA compiler.

Implements the SASE NFA^b construction rules of the reference compiler
(reference: core/.../cep/pattern/StagesFactory.java:49-191):

  * walk the ancestor chain newest -> oldest, prepending a `$final` stage;
  * cardinality ONE -> BEGIN edge, ONE_OR_MORE -> TAKE edge;
  * skip-till-any  -> IGNORE edge with a True predicate;
    skip-till-next -> IGNORE edge with !take;
  * TAKE stages get a PROCEED edge: succ OR !take (strict contiguity) /
    succ OR (!take AND !ignore) (skip strategies);
  * times(n) / one_or_more expand into chained internal BEGIN stages;
  * optional stages get a SKIP_PROCEED edge: succ AND !take;
  * per-stage topic filters are ANDed into predicates;
  * the window is pushed onto every stage.

Raises InvalidPatternException for a final one_or_more/optional stage.
"""
from __future__ import annotations

from typing import List, Optional

from .matcher import Predicate, TopicPredicate, TruePredicate, and_, not_, or_
from .pattern import Cardinality, Pattern, Strategy
from .stages import Edge, EdgeOperation, Stage, Stages, StateType


class InvalidPatternException(Exception):
    pass


def compile_pattern(pattern: Pattern) -> Stages:
    """Compile a Pattern chain into the NFA stage graph."""
    if pattern is None:
        raise ValueError("Cannot compile a null pattern")

    compiler = _Compiler()
    return compiler.compile(pattern)


def ensure_stages(pattern_or_stages) -> Stages:
    """Accept either a Pattern (compiled here, exactly once per call site)
    or an already-compiled Stages -- the normalization every deployment
    entry point shares."""
    if isinstance(pattern_or_stages, Pattern):
        return compile_pattern(pattern_or_stages)
    return pattern_or_stages


class _Compiler:
    def __init__(self) -> None:
        self._next_id = 0

    def _new_id(self) -> int:
        stage_id = self._next_id
        self._next_id += 1
        return stage_id

    def compile(self, pattern: Pattern) -> Stages:
        sequence: List[Stage] = []

        successor_stage = Stage(self._new_id(), "$final", StateType.FINAL)
        sequence.append(successor_stage)

        successor_pattern: Optional[Pattern] = None
        current = pattern
        while current.ancestor is not None:
            stages = self._build_stages(StateType.NORMAL, current, successor_stage, successor_pattern)
            sequence.extend(stages)
            successor_stage = stages[-1]
            successor_pattern = current
            current = current.ancestor
        sequence.extend(self._build_stages(StateType.BEGIN, current, successor_stage, successor_pattern))

        return Stages(sequence)

    def _build_stages(
        self,
        state_type: StateType,
        current: Pattern,
        successor_stage: Stage,
        successor_pattern: Optional[Pattern],
    ) -> List[Stage]:
        cardinality = current.cardinality
        has_mandatory_state = cardinality == Cardinality.ONE_OR_MORE
        current_type = StateType.NORMAL if has_mandatory_state else state_type

        stage = Stage(self._new_id(), current.name, current_type)
        window_ms = self._window_ms(current, successor_pattern)
        stage.window_ms = window_ms
        stage.aggregates = list(current.aggregates)

        selected = current.selected
        # Selected.from_topic leaves the strategy unset; normalize to strict
        # contiguity (the reference would NPE on this input).
        strategy = selected.strategy if selected.strategy is not None else Strategy.STRICT_CONTIGUITY
        predicate: Predicate = current.predicate if current.predicate is not None else TruePredicate()
        if selected.topic is not None:
            predicate = and_(TopicPredicate(selected.topic), predicate)

        operation = EdgeOperation.BEGIN if cardinality == Cardinality.ONE else EdgeOperation.TAKE
        stage.add_edge(Edge(operation, predicate, successor_stage))

        ignore: Optional[Predicate] = None
        if strategy == Strategy.SKIP_TIL_ANY_MATCH:
            ignore = TruePredicate()
            stage.add_edge(Edge(EdgeOperation.IGNORE, ignore, None))
        elif strategy == Strategy.SKIP_TIL_NEXT_MATCH:
            ignore = not_(predicate)
            stage.add_edge(Edge(EdgeOperation.IGNORE, ignore, None))

        if operation == EdgeOperation.TAKE:
            if successor_pattern is None and successor_stage.is_final:
                raise InvalidPatternException(
                    "Cannot define a pattern with a final stage expecting multiple matching events"
                )
            successor_predicate: Predicate = (
                successor_pattern.predicate
                if successor_pattern.predicate is not None
                else TruePredicate()
            )
            if successor_pattern.selected.topic is not None:
                successor_predicate = and_(
                    TopicPredicate(successor_pattern.selected.topic), successor_predicate
                )
            if strategy == Strategy.STRICT_CONTIGUITY:
                proceed = or_(successor_predicate, not_(predicate))
            else:
                proceed = or_(successor_predicate, and_(not_(predicate), not_(ignore)))
            stage.add_edge(Edge(EdgeOperation.PROCEED, proceed, successor_stage))

        stages = [stage]

        times = current.times
        if has_mandatory_state or times > 1:
            while True:
                internal = Stage(self._new_id(), current.name, state_type)
                internal.add_edge(Edge(EdgeOperation.BEGIN, predicate, stage))
                if ignore is not None:
                    internal.add_edge(Edge(EdgeOperation.IGNORE, ignore, None))
                internal.window_ms = window_ms
                internal.aggregates = list(current.aggregates)
                stages.append(internal)
                stage = internal
                times -= 1
                if times <= 1:
                    break

        if current.is_optional:
            if successor_pattern is None and successor_stage.is_final:
                raise InvalidPatternException("Cannot define a pattern with an optional final stage")
            successor_predicate = (
                successor_pattern.predicate
                if successor_pattern.predicate is not None
                else TruePredicate()
            )
            skip = and_(successor_predicate, not_(predicate))
            stage.add_edge(Edge(EdgeOperation.SKIP_PROCEED, skip, successor_stage))

        return stages

    @staticmethod
    def _window_ms(current: Pattern, successor_pattern: Optional[Pattern]) -> int:
        if current.window_ms is not None:
            return current.window_ms
        if successor_pattern is not None and successor_pattern.window_ms is not None:
            return successor_pattern.window_ms
        return -1
