"""Pass registry + the one entry point the CLI and tests call.

``run_lint`` loads the tree once, runs the requested passes, applies
the severity overrides of ``LintConfig.severity`` (``jit-donate`` a
warning by default), and marks
(not drops) findings suppressed by pragmas — the ``--show-suppressed``
view and the JSON output both want to see what was waived and where.
"""

from __future__ import annotations

from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    load_tree,
)
from machine_learning_apache_spark_tpu_torch.analysis.envcheck import run_env
from machine_learning_apache_spark_tpu_torch.analysis.jit_hygiene import run_jit
from machine_learning_apache_spark_tpu_torch.analysis.locks import run_locks
from machine_learning_apache_spark_tpu_torch.analysis.recompile import (
    run_recompile,
)
from machine_learning_apache_spark_tpu_torch.analysis.tracecheck import run_trace

__all__ = ["PASSES", "run_lint"]

PASSES = {
    "recompile": run_recompile,
    "locks": run_locks,
    "env": run_env,
    "jit": run_jit,
    "trace": run_trace,
}


def run_lint(
    paths: list[str],
    root: str,
    config: LintConfig | None = None,
    passes: list[str] | None = None,
) -> list[Finding]:
    """Lint ``paths`` (files/dirs, relative to the current directory)
    and return all findings, sorted by location. Suppressed findings are
    flagged, not filtered — callers decide what to show."""
    if config is None:
        config = LintConfig()
    modules = load_tree(paths, config)
    by_path = {m.path: m for m in modules}
    names = passes if passes is not None else config.passes
    findings: list[Finding] = []
    for name in names:
        if name not in PASSES:
            raise ValueError(
                f"unknown lint pass {name!r} (have: {sorted(PASSES)})"
            )
        findings.extend(PASSES[name](modules, config, root))
    for f in findings:
        if f.rule in config.severity:
            f.severity = config.severity[f.rule]
        mod = by_path.get(f.path)
        # findings pointing outside the tree (docs drift) have no
        # module and therefore no pragma surface
        if mod is not None and mod.pragmas.suppresses(f.rule, f.line):
            f.suppressed = True
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
