"""Pass ``jit`` — hygiene of program-cache calls.

The port's programs are CUDA graphs held by ``utils/graph_cache.
ProgramCache``; a call ``programs(name, fn, *args)`` keys a program by
``name`` and its arguments' signature. Two rules, each the counterpart
of the JAX package's rule of the same id, taken from the cache's own
contract:

- ``jit-donate`` (warning): a program whose function takes state
  (``state``, ``train_state``, ``opt_state``) handed to a cache built
  without ``eager_first_call=True``. A program that changes state must
  not run twice on its first call (the warm run and the capture both
  would); the cache's docstring says such programs need it. Warning, as
  in the JAX package: a program that only reads its state runs twice
  harmlessly. A cache the module only annotates (a parameter) is not
  judged.
- ``jit-static-hashable`` (error): an unhashable literal (list/dict/set,
  or comprehension thereof) among a program call's non-tensor
  arguments. The cache keys programs by those values, so the call raises
  ``TypeError`` — but only on the first call on that code path; the lint
  catches the latent ones.
"""

from __future__ import annotations

import ast

from machine_learning_apache_spark_tpu_torch.analysis.callgraph import (
    build_call_graph,
)
from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Module,
)

__all__ = ["run_jit", "RULES"]

RULES = {
    "jit-donate": "warning",
    "jit-static-hashable": "error",
}

_STATE_PARAMS = {"state", "train_state", "opt_state"}
_UNHASHABLE = (
    ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp,
)


def _eager_first_call(ctor: ast.Call) -> bool:
    for k in ctor.keywords:
        if k.arg == "eager_first_call":
            return isinstance(k.value, ast.Constant) and k.value.value is True
    return False


def _param_names(fn: ast.AST) -> list[str]:
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = fn.args
        return [p.arg for p in [*a.posonlyargs, *a.args]]
    return []


def run_jit(
    modules: list[Module], config: LintConfig, root: str
) -> list[Finding]:
    graph = build_call_graph(modules)
    findings: list[Finding] = []
    for mod, call, cls, enclosing in graph.program_calls():
        label = ast.unparse(call.args[1])
        ctors = graph.cache_ctors(mod, call, cls)
        if ctors and not any(_eager_first_call(c) for c in ctors):
            for info in graph.target_defs(mod, call.args[1], enclosing):
                hit = _STATE_PARAMS.intersection(_param_names(info.node))
                if hit:
                    findings.append(Finding(
                        rule="jit-donate",
                        severity=RULES["jit-donate"],
                        path=mod.path,
                        line=call.lineno,
                        message=(
                            f"program `{label}` takes state "
                            f"(`{sorted(hit)[0]}`) but its cache (line "
                            f"{ctors[0].lineno}) has no "
                            "eager_first_call=True — its first call runs "
                            "the update twice (warm run and capture)"
                        ),
                    ))
                    break
        for pos, arg in enumerate(call.args[2:], start=2):
            if isinstance(arg, _UNHASHABLE):
                findings.append(Finding(
                    rule="jit-static-hashable",
                    severity=RULES["jit-static-hashable"],
                    path=mod.path,
                    line=call.lineno,
                    message=(
                        f"argument {pos} of the `{label}` program call is "
                        "an unhashable literal — the cache keys programs "
                        "by their non-tensor arguments' values and raises "
                        "on first call; pass a tuple or hashable value"
                    ),
                ))
    return findings
