"""kafkastreams_cep_tpu_torch: the batched CEP engine in PyTorch and CUDA.

The port of `kafkastreams_cep_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The pattern DSL, the SASE compiler and the stage tables are the JAX
package's, copied; the device engine is rewritten: engine state as plain
dicts of K-last tensors (ops/engine.py), a plain PyTorch step
(ops/step.py) and the fused step as a CUDA kernel written for sm_90a
(csrc/nfa_step.cu, bound through ops/step_kernel.py), driven by the
multi-key `BatchedDeviceNFA` (parallel/batched.py), the stacked
multi-query `StackedQueryEngine` (parallel/stacked.py) and the single-key
`DeviceNFA` (ops/device_nfa.py), with the host's pack and decode in C++
(native/). Users reach it through the streams API:
`ComplexStreamsBuilder().stream(...).query(..., runtime="cuda")`
(streams/builder.py), whose matches pass an exactly-once emission gate
into a sink, optionally behind an event-time gate (time/); `LogDriver`
(streams/driver.py) pumps a `RecordLog` through such a topology with
commits, restore and dead letters.

The package imports torch and numpy only -- never jax, and nothing of the
JAX package. Kernels and native extensions build at first use, never at
import.
"""

from .core.dewey import DeweyVersion
from .core.event import Event
from .core.sequence import Sequence, SequenceBuilder, Staged
from .nfa.nfa import NFA, ComputationStage, initial_computation_stage
from .obs.registry import MetricsRegistry, default_registry
from .obs.trace import SpanTracer
from .ops.engine import EngineConfig
from .ops.schema import EventSchema
from .ops.tables import CompiledQuery, compile_multi_query, compile_query
from .parallel.batched import BatchedDeviceNFA
from .parallel.stacked import StackedQueryEngine
from .ops.device_nfa import DeviceNFA
from .pattern.builder import QueryBuilder
from .pattern.compiler import InvalidPatternException, compile_pattern
from .pattern.expressions import agg, const, field, key, timestamp, topic_is, value
from .pattern.pattern import Pattern, Selected, Strategy
from .pattern.stages import EdgeOperation, Stage, Stages, StateType
from .state.aggregates import AggregatesStore, States, UnknownAggregateException
from .state.buffer import SharedVersionedBuffer
from .state.builders import QueryStoreBuilders
from .state.nfa_store import NFAStates, NFAStore
from .streams.builder import ComplexStreamsBuilder
from .streams.device_processor import DeviceCEPProcessor
from .streams.driver import LogDriver, produce
from .streams.log import RecordLog
from .streams.processor import CEPProcessor
from .streams.transport import RecordLogServer, SocketRecordLog, TransportError
from .streams.serde import Queried, SinkMatch, sequence_to_dict, sequence_to_json
from .time import (
    ArrivalOrderWatermark,
    BoundedOutOfOrderness,
    EventTimeGate,
    IdleTimeout,
    MinMergeWatermark,
    ReorderBuffer,
)

__all__ = [
    "AggregatesStore", "ArrivalOrderWatermark", "BatchedDeviceNFA", "BoundedOutOfOrderness",
    "CEPProcessor", "CompiledQuery", "ComplexStreamsBuilder", "ComputationStage",
    "DeviceCEPProcessor", "DeviceNFA", "DeweyVersion", "EdgeOperation", "EngineConfig",
    "Event", "EventSchema", "EventTimeGate", "IdleTimeout", "InvalidPatternException",
    "LogDriver", "MetricsRegistry", "MinMergeWatermark", "NFA", "NFAStates", "NFAStore",
    "Pattern", "Queried", "QueryBuilder", "QueryStoreBuilders", "RecordLog", "RecordLogServer",
    "ReorderBuffer", "Selected", "Sequence", "SequenceBuilder", "SharedVersionedBuffer",
    "SinkMatch", "SocketRecordLog", "SpanTracer", "Stage", "StackedQueryEngine", "Staged", "Stages",
    "StateType", "States", "Strategy", "TransportError", "UnknownAggregateException", "agg",
    "compile_multi_query", "compile_pattern", "compile_query", "const",
    "default_registry", "field", "initial_computation_stage", "key", "produce",
    "sequence_to_dict", "sequence_to_json", "timestamp", "topic_is", "value",
]
