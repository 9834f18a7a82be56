"""mlspark-lint for the PyTorch/CUDA port — static analysis of the
invariants the test suite can't see.

The port's copy of ``machine_learning_apache_spark_tpu/analysis``. Its
contracts are negative properties too: no host sync inside a function a
CUDA graph captures (``utils/graph_cache.ProgramCache``: a captured
program "may not synchronise with the host"), no unlocked access to
state shared across serving/fleet/telemetry threads, no ``MLSPARK_*``
read that bypasses the env registry, no program cache keyed by an
unhashable value.

Five passes (``tools/torch_mlspark_lint.py``; the pragma grammar is in
``core.py``):

- ``recompile`` — host-sync hazards in functions reachable from a
  captured program: the functions handed to a ``ProgramCache`` and the
  bodies of ``with torch.cuda.graph(...)`` (call-graph walk over the
  package);
- ``locks``     — ``# guarded-by:`` lock discipline for attributes and
  module globals shared across threads;
- ``env``       — every ``MLSPARK_*`` access goes through the port's
  ``utils/env.py``; registry and ``docs/ENV_TORCH.md`` agree;
- ``jit``       — ``eager_first_call`` on caches whose programs take
  state, and hashable non-tensor program arguments;
- ``trace``     — request annotations emitted under a trace context.

Everything here is stdlib-``ast`` only: the lint runs without importing
the package it analyses (no torch import), so the tier-1 subprocess gate
stays cheap.
"""

from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Module,
    load_tree,
)
from machine_learning_apache_spark_tpu_torch.analysis.run import (
    PASSES,
    run_lint,
)

__all__ = [
    "Finding",
    "LintConfig",
    "Module",
    "PASSES",
    "load_tree",
    "run_lint",
]
