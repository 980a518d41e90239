from .context import FoldEnv, HostEventEnv, MatcherContext
from .nfa import NFA, ComputationStage, initial_computation_stage
