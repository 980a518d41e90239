"""ceplint for the port: invariant-enforcing static analysis.

The engine's hardest-won properties are behavioral contracts no type
checker sees: the zero-sync deferred advance (the step, the pend append
and the group-flush GC queue on the card without a host read),
single-writer-or-locked shared state under the obs / driver / decode
threads, kernel builds that stay cached across traffic churn, and serde
frames that round-trip every field of every checkpointed structure. This
package -- the port's copy of the JAX package's `analysis/`, importing
nothing of it -- turns those invariant classes into machine-checked
lints over the stdlib `ast`.

Checkers (each with a seeded mutation fixture under
tests/fixtures/lint_torch/ proving it can fail):

- ``zerosync``  host reads of a tensor inside hot-path functions
- ``threads``   attributes written from >= 2 thread roots outside a lock
- ``recompile`` kernel-build hazards (a build in a loop or on the
                advance path, a mutable build or cache key)
- ``serde``     checkpoint field round-trip completeness
- ``metrics``   cep_* metric names vs the port's dictionary (obs/metrics_dictionary.py)
- ``tracectx``  wire trace-context propagation through `streams/`

Audited sites are annotated in source with the pragma grammar
``# cep: <kind>(<reason>)`` (see analysis/core.py); residual accepted
findings live in the committed ``ceplint_torch.baseline.json``. The CLI
is ``python -m kafkastreams_cep_tpu_torch.analysis``;
``tests/test_torch_lint.py`` runs the whole gate in tier-1. Runtime
companions: ``analysis/lockmon.py`` (instrumented-lock lock-order cycle
detection) and ``analysis/kernel_audit.py`` (replays epochs of the same
shapes and asserts that no kernel build, module load or
``cep_compiles_total{fn}`` moves).
"""
from .core import (  # noqa: F401
    Finding,
    Pragma,
    SourceFile,
    iter_source_files,
    run_checkers,
    CHECKERS,
)
