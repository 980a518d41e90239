"""Compiled NFA graph: stages and edges.

Re-design of the reference compiled-automaton model
(reference: core/.../cep/nfa/Stage.java:40-252, Stages.java:33-72,
EdgeOperation.java:20-46). A compiled query is an ordered list of stages;
each stage has typed edges (BEGIN/TAKE/PROCEED/SKIP_PROCEED/IGNORE) carrying
a predicate and a target stage. The device compiler (ops/tables.py) packs
this graph into fixed transition tables.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Set

from .aggregator import StateAggregator
from .matcher import Predicate, TruePredicate


class EdgeOperation(enum.Enum):
    """Edge kinds (EdgeOperation.java:20-46)."""

    BEGIN = "begin"            # forward transition, consumes the event
    TAKE = "take"              # self loop, consumes the event
    PROCEED = "proceed"        # epsilon forward transition
    SKIP_PROCEED = "skip_proceed"  # epsilon forward for optional stages
    IGNORE = "ignore"          # self loop, does not consume


class StateType(enum.Enum):
    BEGIN = "begin"
    NORMAL = "normal"
    FINAL = "final"


class Edge:
    __slots__ = ("operation", "predicate", "target")

    def __init__(self, operation: EdgeOperation, predicate: Predicate, target: Optional["Stage"]) -> None:
        if predicate is None:
            raise ValueError("predicate cannot be None")
        self.operation = operation
        self.predicate = predicate
        self.target = target

    def is_op(self, op: EdgeOperation) -> bool:
        return self.operation == op

    def __repr__(self) -> str:
        tgt = self.target.name if self.target is not None else None
        return f"Edge({self.operation.name} -> {tgt})"


class Stage:
    """One compiled NFA state: id, name, type, window, folds, edge list."""

    def __init__(self, stage_id: int, name: str, state_type: StateType) -> None:
        self.id = stage_id
        self.name = name
        self.type = state_type
        self.window_ms: int = -1
        self.aggregates: List[StateAggregator] = []
        self.edges: List[Edge] = []

    def add_edge(self, edge: Edge) -> "Stage":
        self.edges.append(edge)
        return self

    @property
    def is_begin(self) -> bool:
        return self.type == StateType.BEGIN

    @property
    def is_final(self) -> bool:
        return self.type == StateType.FINAL

    def is_epsilon(self) -> bool:
        return len(self.edges) == 1 and self.edges[0].operation == EdgeOperation.PROCEED

    def get_target(self, op: EdgeOperation) -> Optional["Stage"]:
        target = None
        for edge in self.edges:
            if edge.operation == op:
                target = edge.target
        return target

    def __repr__(self) -> str:
        return f"Stage(id={self.id}, name={self.name!r}, type={self.type.name}, edges={self.edges})"

    @staticmethod
    def new_epsilon(current: "Stage", target: "Stage") -> "Stage":
        """A runtime forwarding state: current's identity, one PROCEED->target.

        Mirrors Stage.newEpsilonState (Stage.java:247-251); the device engine
        removes the need for these synthesized objects by storing
        (eval-stage, prev-stage, pending-version-extension) per run lane.
        """
        eps = Stage(current.id, current.name, current.type)
        eps.add_edge(Edge(EdgeOperation.PROCEED, TruePredicate(), target))
        return eps


class Stages:
    """The compiled stage list for one query (Stages.java:33-72)."""

    def __init__(self, stages: List[Stage]) -> None:
        self.stages = stages

    def begin_stage(self) -> Stage:
        for stage in self.stages:
            if stage.is_begin:
                return stage
        raise ValueError("compiled query has no begin stage")

    def defined_states(self) -> Set[str]:
        names: Set[str] = set()
        for stage in self.stages:
            for aggregate in stage.aggregates:
                names.add(aggregate.name)
        return names

    def __iter__(self):
        return iter(self.stages)

    def __len__(self) -> int:
        return len(self.stages)
