"""Pass ``locks`` — ``# guarded-by:`` lock discipline.

The port's copy of the JAX package's pass, unchanged in meaning.

Serving, fleet, and telemetry all share mutable state across threads
(scrape threads read engine health while the decode thread writes it;
the admission gate bumps counters from every request thread). The
convention enforced here makes the locking contract *declarative*:

    self._requests = 0      # guarded-by: self._lock
    _SERVER = None          # guarded-by: _STATE_LOCK

Every later access to a declared attribute/global must then be

- lexically inside ``with <lock>:`` on the declared lock, or
- inside a function annotated ``# mlspark-lint: holds <lock>`` on its
  ``def`` line (callers own the lock — documented, checkable), or
- inside the method that made the declaration (construction: the object
  is not shared yet), or
- at module import time (for globals).

Anything else is ``locks-guarded-attr`` / ``locks-guarded-global``
(error). Nested functions and lambdas do **not** inherit the held set:
a closure defined under ``with lock:`` usually outlives the critical
section. Annotate the closure with ``holds`` if it really runs inside.
"""

from __future__ import annotations

import ast

from machine_learning_apache_spark_tpu_torch.analysis.core import (
    GUARDED_BY_RE,
    Finding,
    LintConfig,
    Module,
)

__all__ = ["run_locks", "RULES"]

RULES = {
    "locks-guarded-attr": "error",
    "locks-guarded-global": "error",
}

_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


def _norm(expr: str) -> str:
    """Canonical spelling of a lock expression for comparison."""
    try:
        return ast.unparse(ast.parse(expr.strip(), mode="eval").body)
    except (SyntaxError, ValueError):
        return expr.strip().replace(" ", "")


def _guard_lines(mod: Module) -> dict[int, str]:
    """line -> declared lock expr. A ``guarded-by`` comment on a line of
    its own covers the next line (long-declaration escape hatch)."""
    out: dict[int, str] = {}
    for i, text in enumerate(mod.lines, start=1):
        m = GUARDED_BY_RE.search(text)
        if not m:
            continue
        lock = _norm(m.group(1))
        out[i] = lock
        if text.lstrip().startswith("#"):
            out.setdefault(i + 1, lock)
    return out


def _holds(mod: Module, fn: ast.AST) -> set[str]:
    """Locks a function declares it is called with (``holds`` pragma on
    or just below its ``def`` line, above the first body statement)."""
    if not isinstance(fn, _FUNC):
        return set()
    first = fn.body[0].lineno if fn.body else fn.lineno
    held: set[str] = set()
    for line in range(fn.lineno, first + 1):
        held |= {_norm(s) for s in mod.holds.get(line, set())}
    return held


class _Decls:
    """Declared guarded state for one module."""

    def __init__(self) -> None:
        #: class name -> attr -> (lock, declaring function node id)
        self.attrs: dict[str, dict[str, tuple[str, int]]] = {}
        #: global name -> lock
        self.globals: dict[str, str] = {}


def _collect(mod: Module, guards: dict[int, str]) -> _Decls:
    decls = _Decls()

    def scan(node: ast.AST, cls: str | None, fn: ast.AST | None) -> None:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            lock = guards.get(node.lineno)
            if lock:
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and cls is not None
                    ):
                        decls.attrs.setdefault(cls, {})[t.attr] = (
                            lock, id(fn) if fn is not None else 0,
                        )
                    elif isinstance(t, ast.Name):
                        if cls is None and fn is None:
                            decls.globals[t.id] = lock
                        elif cls is not None and fn is None:
                            # class-level attribute declaration
                            decls.attrs.setdefault(cls, {})[t.id] = (
                                lock, 0,
                            )
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan_children(child, child.name, None)
            elif isinstance(child, _FUNC + (ast.Lambda,)):
                scan_children(child, cls, child)
            else:
                scan(child, cls, fn)

    def scan_children(node: ast.AST, cls: str | None, fn) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan_children(child, child.name, None)
            elif isinstance(child, _FUNC + (ast.Lambda,)):
                scan_children(child, cls, child)
            else:
                scan(child, cls, fn)

    scan(mod.tree, None, None)
    return decls


def run_locks(
    modules: list[Module], config: LintConfig, root: str
) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        guards = _guard_lines(mod)
        if not guards:
            continue
        decls = _collect(mod, guards)
        if not decls.attrs and not decls.globals:
            continue

        def check(
            node: ast.AST,
            cls: str | None,
            fn: ast.AST | None,
            held: frozenset,
        ) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = {
                    _norm(ast.unparse(item.context_expr))
                    for item in node.items
                }
                for item in node.items:
                    check(item, cls, fn, held)
                inner = held | acquired
                for stmt in node.body:
                    check(stmt, cls, fn, inner)
                return
            if isinstance(node, ast.ClassDef):
                for child in ast.iter_child_nodes(node):
                    check(child, node.name, None, frozenset())
                return
            if isinstance(node, _FUNC + (ast.Lambda,)):
                # fresh held set: closures don't inherit the critical
                # section they were defined in
                inner = frozenset(_holds(mod, node))
                for child in ast.iter_child_nodes(node):
                    check(child, cls, node, inner)
                return

            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and cls is not None
                and node.attr in decls.attrs.get(cls, {})
            ):
                lock, decl_fn = decls.attrs[cls][node.attr]
                if lock not in held and (fn is None or id(fn) != decl_fn):
                    findings.append(Finding(
                        rule="locks-guarded-attr",
                        severity=RULES["locks-guarded-attr"],
                        path=mod.path,
                        line=node.lineno,
                        message=(
                            f"`self.{node.attr}` is declared guarded-by "
                            f"`{lock}` but accessed without it (wrap in "
                            f"`with {lock}:` or annotate the function "
                            f"`# mlspark-lint: holds {lock}`)"
                        ),
                    ))
            elif (
                isinstance(node, ast.Name)
                and node.id in decls.globals
                and fn is not None
            ):
                lock = decls.globals[node.id]
                if lock not in held:
                    findings.append(Finding(
                        rule="locks-guarded-global",
                        severity=RULES["locks-guarded-global"],
                        path=mod.path,
                        line=node.lineno,
                        message=(
                            f"global `{node.id}` is declared guarded-by "
                            f"`{lock}` but accessed without it"
                        ),
                    ))
            for child in ast.iter_child_nodes(node):
                check(child, cls, fn, held)

        for top in mod.tree.body:
            check(top, None, None, frozenset())
    return findings
