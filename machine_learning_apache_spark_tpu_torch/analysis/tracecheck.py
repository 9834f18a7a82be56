"""Pass ``trace`` — request annotations must ride a trace context.

The port's copy of the JAX package's pass, unchanged in meaning.

The distributed-tracing invariant: the ``fleet.request`` and
``serving.request`` annotation events are each request's terminal record
(outcome, latency breakdown), and ``telemetry.traceview`` stitches them
into the request's tree via the ``trace`` field the event log stamps
from the thread's active :mod:`~machine_learning_apache_spark_tpu_torch.telemetry.tracectx`
context. An emission site that is not under ``with use(...)`` produces
an annotation with no trace id — the request's summary silently falls
out of every stitched view, which is exactly the kind of regression a
reader of the *emitting* code cannot see.

Rule:

- ``trace-no-context`` (error): a call that emits one of the request
  annotations — ``annotate("fleet.request", ...)`` /
  ``annotate("serving.request", ...)`` (any ``annotate`` spelling) or
  ``.emit("annotation", "<name>", ...)`` — that is not **lexically**
  inside a ``with`` statement having a ``use(...)`` /
  ``tracectx.use(...)`` context item. The check is lexical on purpose:
  dynamic context installation exists (worker threads re-activating a
  request's saved ctx), and such sites carry a pragma with the
  justification.

Suppress with ``# mlspark-lint: ok trace-no-context -- <why>``.
"""

from __future__ import annotations

import ast

from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Module,
)

__all__ = ["RULES", "TRACED_ANNOTATIONS", "run_trace"]

RULES = {
    "trace-no-context": "error",
}

#: Annotation names that are per-request terminal records — the ones the
#: stitched trace views key on.
TRACED_ANNOTATIONS = frozenset({"fleet.request", "serving.request"})


def _str_arg(node: ast.Call, i: int) -> str | None:
    if len(node.args) > i and isinstance(node.args[i], ast.Constant) \
            and isinstance(node.args[i].value, str):
        return node.args[i].value
    return None


def _is_traced_emission(node: ast.Call) -> str | None:
    """The traced annotation name this call emits, or None."""
    f = node.func
    fname = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None
    )
    if fname == "annotate":
        name = _str_arg(node, 0)
        return name if name in TRACED_ANNOTATIONS else None
    if fname == "emit" and _str_arg(node, 0) == "annotation":
        name = _str_arg(node, 1)
        return name if name in TRACED_ANNOTATIONS else None
    return None


def _has_use_item(node: ast.With) -> bool:
    for item in node.items:
        ce = item.context_expr
        if isinstance(ce, ast.Call):
            f = ce.func
            if (isinstance(f, ast.Name) and f.id == "use") or (
                isinstance(f, ast.Attribute) and f.attr == "use"
            ):
                return True
    return False


def run_trace(
    modules: list[Module], config: LintConfig, root: str  # noqa: ARG001
) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:

        def visit(node: ast.AST, under_use: bool) -> None:
            if isinstance(node, ast.With):
                under_use = under_use or _has_use_item(node)
            elif isinstance(node, ast.Call):
                name = _is_traced_emission(node)
                if name is not None and not under_use:
                    findings.append(Finding(
                        rule="trace-no-context",
                        severity=RULES["trace-no-context"],
                        path=mod.path, line=node.lineno,
                        message=(
                            f"`{name}` annotation emitted outside a"
                            " `with use(...)` trace-context block — the"
                            " event gets no trace id and the request"
                            " drops out of every stitched trace view"
                            " (wrap the emission in `with"
                            " tracectx.use(ctx):`, or pragma with the"
                            " justification if the context is installed"
                            " dynamically)"
                        ),
                    ))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                # A nested function body does not inherit the lexical
                # with-block: it runs later, on whatever thread calls it.
                under_use = False
            for child in ast.iter_child_nodes(node):
                visit(child, under_use)

        visit(mod.tree, False)
    return findings
