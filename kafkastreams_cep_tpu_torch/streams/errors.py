"""The streams layer's error classes: re-exports of `faults/injection.py`'s,
so that an overflow raised by the engine, the event-time gate or the
driver is one class to every caller."""
from ..faults.injection import CEPOverflowError, PoisonRecords, TransientFault

__all__ = ["CEPOverflowError", "PoisonRecords", "TransientFault"]
