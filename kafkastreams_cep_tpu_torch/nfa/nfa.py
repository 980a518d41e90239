"""Host NFA runtime: the per-record match loop.

This is the behavioral oracle for the TPU engine: a faithful re-implementation
of the reference SASE NFA^b evaluator
(reference: core/.../cep/nfa/NFA.java:134-397, ComputationStage.java:30-185).
Per event it drains the run queue once, evaluates each live run against the
compiled stage graph (recursively descending epsilon PROCEED chains), applies
the edge operations:

  * PROCEED/SKIP_PROCEED: epsilon descent, extending the Dewey version with a
    new stage digit when genuinely crossing to the next stage;
  * TAKE: consume on a self loop, re-adding the run, buffer put chained to
    the run's lineage (NFA.java:238-255);
  * BEGIN: consume and forward via a synthesized epsilon state
    (NFA.java:256-271);
  * IGNORE: re-add the run unchanged (NFA.java:272-285);

branches a run when one event matches >=2 edge combinations
(PROCEED+TAKE / IGNORE+TAKE / IGNORE+BEGIN / IGNORE+PROCEED,
NFA.java:392-397) -- cloning the run with a bumped Dewey number (addRun(2)
from a begin state), duplicating fold registers and sharing the lineage
prefix -- and always re-adds the begin state so new matches can start
(NFA.java:323-338). Matches are extracted from the shared buffer when a run
forwards to the final state.

Partial matches live in the exact-lineage shared buffer (state/buffer.py):
each run tracks the node id of its last consumed event (`last_node`, the
host analog of the device engine's per-lane node index) and extraction is an
unambiguous parent walk. The reference instead routes a merged
(stage, event)-keyed store by Dewey-version compatibility
(SharedVersionedBufferStoreImpl.java:176-201), which splices runs' prefixes
whenever independent addRun() bumps produce colliding version tags -- a
reference bug this redesign does not reproduce (see state/buffer.py).
Dewey versions are still maintained run-for-run (they are part of the
observable run-queue shape and drive branch numbering) -- they just no
longer route storage.

The TPU engine (ops/engine.py) implements the same transition relation as a
vmapped kernel over fixed-capacity run lanes with the epsilon descent
unrolled at query-compile time; this interpreter defines its conformance
contract.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Generic, List, Optional, Set, TypeVar

from ..core.dewey import DeweyVersion
from ..core.event import Event
from ..core.sequence import Sequence
from ..pattern.stages import Edge, EdgeOperation, Stage, Stages
from ..state.aggregates import AggregatesStore, States
from ..state.buffer import ReadOnlySharedVersionBuffer, SharedVersionedBuffer
from .context import FoldEnv, MatcherContext

K = TypeVar("K")
V = TypeVar("V")


@dataclass(frozen=True)
class ComputationStage(Generic[K, V]):
    """One live NFA run (ComputationStage.java:30-185)."""

    stage: Stage
    version: DeweyVersion
    sequence: int
    last_event: Optional[Event[K, V]] = None
    timestamp: int = -1
    is_branching: bool = False
    is_ignored: bool = False
    #: buffer node id of the run's last consumed event (chain head). The
    #: reference reconstructs a store key from (previousStage, previousEvent)
    #: at put time (NFA.java:351-360), which breaks when the storing stage
    #: and the descent's previous stage carry different StateTypes; tracking
    #: the chain head explicitly is the host analog of the device engine's
    #: per-lane last-node *index* and sidesteps both that bug and the
    #: version-routing ambiguity (see state/buffer.py).
    last_node: Optional[int] = None

    def with_version(self, version: DeweyVersion) -> "ComputationStage[K, V]":
        # Mirrors ComputationStage.setVersion: branching/ignored flags reset.
        return ComputationStage(
            self.stage, version, self.sequence, self.last_event, self.timestamp,
            last_node=self.last_node,
        )

    @property
    def is_begin_state(self) -> bool:
        return self.stage.is_begin

    def is_out_of_window(self, time: int) -> bool:
        return self.stage.window_ms != -1 and (time - self.timestamp) > self.stage.window_ms

    @property
    def is_forwarding(self) -> bool:
        edges = self.stage.edges
        return len(edges) == 1 and edges[0].operation == EdgeOperation.PROCEED

    @property
    def is_forwarding_to_final(self) -> bool:
        return self.is_forwarding and self.stage.edges[0].target.is_final


def initial_computation_stage(stages: Stages) -> ComputationStage:
    return ComputationStage(stage=stages.begin_stage(), version=DeweyVersion(1), sequence=1)


class NFA(Generic[K, V]):
    """Non-deterministic finite automaton over the exact-lineage shared buffer."""

    def __init__(
        self,
        aggregates_store: AggregatesStore,
        buffer: SharedVersionedBuffer[K, V],
        aggregates_names: Set[str],
        computation_stages: List[ComputationStage[K, V]],
        runs: int = 1,
        strict_windows: bool = False,
    ) -> None:
        self.aggregates_store = aggregates_store
        self.buffer = buffer
        self.aggregates_names = set(aggregates_names)
        self.computation_stages: List[ComputationStage[K, V]] = list(computation_stages)
        self.runs = runs
        # Reference parity (False): synthesized epsilon stages carry no window
        # (Stage.java:247-251 never copies windowMs, DEFAULT_WINDOW_MS=-1 at
        # Stage.java:42), so any run that has consumed an event -- which always
        # sits at an epsilon stage -- is never expired, run populations grow
        # without bound under skip-till-any, and matches can span longer than
        # within(). strict_windows=True fixes that documented reference leak:
        # epsilon stages inherit the descent target's window and expiry keys
        # off "has consumed an event" instead of "is not the begin stage".
        self.strict_windows = strict_windows

    @staticmethod
    def build(
        stages: Stages,
        aggregates_store: AggregatesStore,
        buffer: SharedVersionedBuffer,
        strict_windows: bool = False,
    ) -> "NFA":
        return NFA(
            aggregates_store,
            buffer,
            stages.defined_states(),
            [initial_computation_stage(stages)],
            strict_windows=strict_windows,
        )

    # ------------------------------------------------------------------ API
    def match_pattern(self, event: Event[K, V]) -> List[Sequence[K, V]]:
        """Process one event; returns completed matches in emission order."""
        to_process = len(self.computation_stages)
        final_states: List[ComputationStage[K, V]] = []
        any_died = False

        while to_process > 0:
            to_process -= 1
            computation = self.computation_stages.pop(0)
            states = self._match_computation(computation, event)
            if not states:
                any_died = True
            final_states.extend(s for s in states if s.is_forwarding_to_final)
            self.computation_stages.extend(s for s in states if not s.is_forwarding_to_final)

        matches = self._match_construction(final_states)
        # Reclaim chains no longer reachable from any live run: the mark-sweep
        # that replaces the reference's per-extraction refcount GC
        # (SharedVersionedBufferStoreImpl.java:176-201). Nodes can only become
        # unreachable when a run dies or leaves the queue through the final
        # state (every other transition retains its chain prefix), so the
        # sweep is skipped otherwise.
        if final_states or any_died:
            self.buffer.gc(c.last_node for c in self.computation_stages)
        return matches

    # ------------------------------------------------------------ internals
    def _match_construction(
        self, states: List[ComputationStage[K, V]]
    ) -> List[Sequence[K, V]]:
        return [self.buffer.get(c.last_node) for c in states]

    def _match_computation(
        self, computation: ComputationStage[K, V], event: Event[K, V]
    ) -> List[ComputationStage[K, V]]:
        if self.strict_windows:
            # Expire any run that has consumed an event (timestamp set); the
            # begin run itself (timestamp -1) has nothing to expire.
            expired = computation.timestamp >= 0 and computation.is_out_of_window(
                event.timestamp
            )
        else:
            # Reference parity (NFA.java:183-184): begin-typed queue items --
            # including the epsilon state a consumed begin run sits at -- are
            # exempt, and epsilon stages carry no window at all.
            expired = not computation.is_begin_state and computation.is_out_of_window(
                event.timestamp
            )
        if expired:
            return []
        return self._evaluate(computation, event, computation.stage, None)

    def _new_epsilon(self, current: Stage, target: Stage) -> Stage:
        eps = Stage.new_epsilon(current, target)
        if self.strict_windows:
            eps.window_ms = (
                target.window_ms if target.window_ms != -1 else current.window_ms
            )
        return eps

    def _matched_edges(
        self,
        previous_event: Optional[Event[K, V]],
        current_event: Event[K, V],
        version: DeweyVersion,
        sequence: int,
        previous_stage: Optional[Stage],
        current_stage: Stage,
        previous_node: Optional[int] = None,
    ) -> List[Edge]:
        states = States(self.aggregates_store, current_event.key, sequence)
        read_only = ReadOnlySharedVersionBuffer(self.buffer)
        ctx_args = dict(
            buffer=read_only,
            version=version,
            previous_stage=previous_stage,
            current_stage=current_stage,
            previous_event=previous_event,
            current_event=current_event,
            states=states,
            previous_node=previous_node,
        )
        return [e for e in current_stage.edges if e.predicate.accept(MatcherContext(**ctx_args))]

    @staticmethod
    def _is_branching(operations: List[EdgeOperation]) -> bool:
        ops = set(operations)
        return (
            {EdgeOperation.PROCEED, EdgeOperation.TAKE} <= ops
            or {EdgeOperation.IGNORE, EdgeOperation.TAKE} <= ops
            or {EdgeOperation.IGNORE, EdgeOperation.BEGIN} <= ops
            or {EdgeOperation.IGNORE, EdgeOperation.PROCEED} <= ops
        )

    def _evaluate(
        self,
        root: ComputationStage[K, V],
        event: Event[K, V],
        current_stage: Stage,
        previous_stage: Optional[Stage],
        computation: Optional[ComputationStage[K, V]] = None,
    ) -> List[ComputationStage[K, V]]:
        """Evaluate `current_stage`'s edges for one run; recursive over epsilon chains.

        `root` is the queue item being processed (its begin-state re-add rule
        applies once, at any depth); `computation` is the effective run state
        at this recursion level (version possibly extended by addStage).
        """
        if computation is None:
            computation = root

        sequence_id = computation.sequence
        previous_event = computation.last_event
        previous_node = computation.last_node
        version = computation.version

        matched_edges = self._matched_edges(
            previous_event, event, version, sequence_id, previous_stage, current_stage,
            previous_node,
        )
        operations = [e.operation for e in matched_edges]
        is_branching = self._is_branching(operations)
        ignored = EdgeOperation.IGNORE in operations

        start_time = event.timestamp if root.is_begin_state else computation.timestamp

        next_stages: List[ComputationStage[K, V]] = []
        consumed = False
        proceed = False
        consumed_node: Optional[int] = None

        for edge in matched_edges:
            op = edge.operation

            if op in (EdgeOperation.PROCEED, EdgeOperation.SKIP_PROCEED):
                next_computation = computation
                if self._is_forwarding_to_next_stage(current_stage, computation, edge):
                    next_computation = computation.with_version(version.add_stage())
                prev_for_descent = (
                    previous_stage if op == EdgeOperation.SKIP_PROCEED else current_stage
                )
                descended = self._evaluate(
                    root, event, edge.target, prev_for_descent, next_computation
                )
                next_stages.extend(descended)
                if descended:
                    proceed = True

            elif op == EdgeOperation.TAKE:
                # Consume on the self loop: the run stays at this stage
                # (NFA.java:238-255; the reference's branch-aware put version
                # only routed the merged store -- lineage needs no tag).
                consumed_node = self.buffer.put(current_stage.name, event, previous_node)
                next_stages.append(
                    ComputationStage(
                        stage=self._new_epsilon(current_stage, current_stage),
                        version=version,
                        sequence=sequence_id,
                        last_event=event,
                        timestamp=start_time,
                        last_node=consumed_node,
                    )
                )
                consumed = True

            elif op == EdgeOperation.BEGIN:
                consumed_node = self.buffer.put(current_stage.name, event, previous_node)
                next_stages.append(
                    ComputationStage(
                        stage=self._new_epsilon(current_stage, edge.target),
                        version=version,
                        sequence=sequence_id,
                        last_event=event,
                        timestamp=start_time,
                        last_node=consumed_node,
                    )
                )
                consumed = True

            elif op == EdgeOperation.IGNORE:
                if not is_branching:
                    next_stages.append(replace(computation, is_ignored=True, is_branching=False))

        if is_branching:
            if consumed:
                self.runs += 1
                new_sequence = self.runs
                last_event = previous_event if ignored else event
                prev_is_begin = previous_stage is not None and previous_stage.is_begin
                if previous_stage is not None:
                    branch_stage = self._new_epsilon(previous_stage, current_stage)
                else:
                    # Begin-stage branching (untestable in the reference:
                    # NFA.java:293 would NPE); park the clone at the current
                    # stage itself.
                    branch_stage = self._new_epsilon(current_stage, current_stage)
                    prev_is_begin = True
                run_offset = 2 if (prev_is_begin and len(version.digits) >= 2) else 1
                next_version = version.add_run(run_offset)
                # The clone shares the lineage prefix by pointing at the same
                # node: the reference's branch() refcount walk
                # (NFA.java:289-317) is structural sharing here.
                clone_node = previous_node if ignored else consumed_node
                next_stages.append(
                    ComputationStage(
                        stage=branch_stage,
                        version=next_version,
                        sequence=new_sequence,
                        last_event=last_event,
                        timestamp=start_time,
                        is_branching=True,
                        last_node=clone_node,
                    )
                )
                for agg_name in self.aggregates_names:
                    self.aggregates_store.branch(event.key, agg_name, sequence_id, new_sequence)
            elif not proceed:
                next_stages.append(root)

        if consumed:
            self._evaluate_aggregates(current_stage, sequence_id, event)

        # The begin state is always re-added so new matches can start.
        if root.is_begin_state and not root.is_forwarding:
            if consumed:
                self.runs += 1
                new_version = version if not next_stages else version.add_run()
                next_stages.append(
                    ComputationStage(
                        stage=root.stage,
                        version=new_version,
                        sequence=self.runs,
                    )
                )
            else:
                next_stages.append(root)

        return next_stages

    @staticmethod
    def _is_forwarding_to_next_stage(
        current_stage: Stage, computation: ComputationStage, edge: Edge
    ) -> bool:
        return (
            edge.target.name != current_stage.name
            and not computation.is_branching
            and not computation.is_ignored
        )

    def _evaluate_aggregates(self, stage: Stage, sequence: int, event: Event[K, V]) -> None:
        for aggregator in stage.aggregates:
            current = self.aggregates_store.find(event.key, aggregator.name, sequence)
            if current is None:
                current = aggregator.initial
            states = States(self.aggregates_store, event.key, sequence)

            def env_factory(cur, _agg=aggregator, _states=states):
                return FoldEnv(event, _states, _agg.name, cur)

            new_value = aggregator.apply(event.key, event.value, current, env_factory)
            self.aggregates_store.put(event.key, aggregator.name, sequence, new_value)
