"""Predicate evaluation context for the host NFA path.

Re-design of the reference evaluation context
(reference: core/.../cep/pattern/MatcherContext.java:31-83). Bundles the
read-only buffer view, the current Dewey version, previous/current stage and
event, and the fold-state view; also adapts itself into an expression `Env`
so declarative predicates evaluate identically on host and device.
"""
from __future__ import annotations

from typing import Any, Optional

from ..core.dewey import DeweyVersion
from ..core.event import Event
from ..core.sequence import Sequence
from ..pattern.expressions import Env
from ..pattern.stages import Stage
from ..state.aggregates import States
from ..state.buffer import ReadOnlySharedVersionBuffer


class MatcherContext:
    __slots__ = (
        "buffer",
        "version",
        "previous_stage",
        "current_stage",
        "previous_event",
        "current_event",
        "states",
        "previous_node",
    )

    def __init__(
        self,
        buffer: ReadOnlySharedVersionBuffer,
        version: DeweyVersion,
        previous_stage: Optional[Stage],
        current_stage: Stage,
        previous_event: Optional[Event],
        current_event: Event,
        states: States,
        previous_node: Optional[int] = None,
    ) -> None:
        self.buffer = buffer
        self.version = version
        self.previous_stage = previous_stage
        self.current_stage = current_stage
        self.previous_event = previous_event
        self.current_event = current_event
        self.states = states
        self.previous_node = previous_node

    def partial_sequence(self) -> Sequence:
        """Materialize the partial match for sequence predicates.

        Mirrors SequenceMatcher's default accept (SequenceMatcher.java:22-26):
        walks the run's lineage chain from its last stored node
        (ComputationStage.last_node); an exact parent walk, no version
        routing (see state/buffer.py).
        """
        if self.previous_node is None:
            return Sequence([])
        return self.buffer.get(self.previous_node)

    def env(self) -> "HostEventEnv":
        return HostEventEnv(self.current_event, self.states)


class HostEventEnv(Env):
    """Expression environment over a single host event + fold registers."""

    __slots__ = ("_event", "_states")

    def __init__(self, event: Event, states: Optional[States]) -> None:
        self._event = event
        self._states = states

    def field(self, name: str) -> Any:
        value = self._event.value
        if name == "":
            return value
        if isinstance(value, dict):
            return value[name]
        return getattr(value, name)

    def key(self) -> Any:
        return self._event.key

    def value(self) -> Any:
        return self._event.value

    def timestamp(self) -> Any:
        return self._event.timestamp

    def topic_is(self, topic: str) -> Any:
        return self._event.topic == topic

    def agg(self, name: str, default: Any = None) -> Any:
        if self._states is None:
            raise ValueError("aggregate reference outside a stateful context")
        if default is None:
            return self._states.get(name)
        return self._states.get_or_else(name, default)


class FoldEnv(HostEventEnv):
    """Environment for fold updates: agg(own-name) resolves to the current register."""

    __slots__ = ("_own_name", "_current")

    def __init__(
        self, event: Event, states: Optional[States], own_name: str, current: Any
    ) -> None:
        super().__init__(event, states)
        self._own_name = own_name
        self._current = current

    def agg(self, name: str, default: Any = None) -> Any:
        if name == self._own_name:
            if self._current is None:
                return default if default is not None else 0
            return self._current
        return super().agg(name, default)
