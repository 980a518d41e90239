"""The streams layer: topology builder, log driver, record log and its
wire transport (the JAX package's `streams/` exports).

The names resolve at first use: the engine (parallel/batched.py) imports
`streams.serde`, and an eager import of the builder here would import
the engine back while it is half initialised."""
import importlib

_EXPORTS = {
    "CEPStream": "builder", "ComplexStreamsBuilder": "builder",
    "OutputStream": "builder", "Record": "builder", "Topology": "builder",
    "LogDriver": "driver", "produce": "driver",
    "LogRecord": "log", "RecordLog": "log",
    "CEPProcessor": "processor",
    "RecordLogServer": "transport", "SocketRecordLog": "transport",
    "TransportError": "transport",
    "Queried": "serde", "sequence_to_dict": "serde", "sequence_to_json": "serde",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
