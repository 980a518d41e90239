"""The engine's capacity-overflow error (a copy of the JAX package's
`faults/injection.py` class of the same name)."""
from __future__ import annotations


class CEPOverflowError(RuntimeError):
    """Engine capacity overflow escalated by `EngineConfig.on_overflow`.

    Raised (policy "raise", and "block" when backpressure could not keep
    the run loss-free) instead of the default loud-drop accounting. When
    raised from a drain boundary, `.matches` carries the successfully
    drained matches (the ring was already pulled), so callers can still
    deliver them."""

    #: Matches drained before the escalation (set at drain boundaries).
    matches = None
