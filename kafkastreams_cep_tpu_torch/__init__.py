"""kafkastreams_cep_tpu_torch: the batched CEP engine in PyTorch and CUDA.

The port of `kafkastreams_cep_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100. The pattern DSL, the SASE compiler and the stage tables are the JAX
package's, copied; the device engine is rewritten: engine state as plain
dicts of K-last tensors (ops/engine.py), a plain PyTorch step
(ops/step.py) and the fused step as a CUDA kernel written for sm_90a
(csrc/nfa_step.cu, bound through ops/step_kernel.py), driven by the
multi-key `BatchedDeviceNFA` (parallel/batched.py), with the host's pack
and decode in C++ (native/). Users reach it through the streams API:
`ComplexStreamsBuilder().stream(...).query(..., runtime="cuda")`
(streams/builder.py), whose matches pass an exactly-once emission gate
into a sink.

The package imports torch and numpy only -- never jax, and nothing of the
JAX package. Kernels and native extensions build at first use, never at
import.
"""

from .core.dewey import DeweyVersion
from .core.event import Event
from .core.sequence import Sequence, SequenceBuilder, Staged
from .ops.engine import EngineConfig
from .ops.schema import EventSchema
from .ops.tables import CompiledQuery, compile_query
from .parallel.batched import BatchedDeviceNFA
from .pattern.builder import QueryBuilder
from .pattern.compiler import InvalidPatternException, compile_pattern
from .pattern.expressions import agg, const, field, key, timestamp, topic_is, value
from .pattern.pattern import Pattern, Selected, Strategy
from .pattern.stages import EdgeOperation, Stage, Stages, StateType
from .streams.builder import ComplexStreamsBuilder
from .streams.log import RecordLog
from .streams.serde import Queried, SinkMatch, sequence_to_dict, sequence_to_json

__all__ = [
    "BatchedDeviceNFA", "CompiledQuery", "ComplexStreamsBuilder", "DeweyVersion",
    "EdgeOperation", "EngineConfig", "Event", "EventSchema",
    "InvalidPatternException", "Pattern", "QueryBuilder", "Queried", "RecordLog",
    "Selected", "Sequence", "SequenceBuilder", "SinkMatch", "Stage", "Staged",
    "Stages", "StateType", "Strategy", "agg",
    "compile_pattern", "compile_query", "const", "field", "key",
    "sequence_to_dict", "sequence_to_json", "timestamp", "topic_is", "value",
]
