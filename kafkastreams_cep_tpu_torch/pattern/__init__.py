from .builder import QueryBuilder
from .compiler import InvalidPatternException, compile_pattern
from .expressions import agg, const, field, key, timestamp, topic_is, value
from .matcher import (
    AndPredicate, ExprPredicate, NotPredicate, OrPredicate, Predicate,
    SequencePredicate, SimplePredicate, StatefulPredicate, TopicPredicate,
    TruePredicate, and_, coerce_predicate, not_, or_,
)
from .aggregator import StateAggregator
from .pattern import Cardinality, Pattern, Selected, Strategy
from .stages import Edge, EdgeOperation, Stage, Stages, StateType
