"""Pass ``recompile`` — host-sync hazards in captured programs.

A program the port captures as a CUDA graph (``utils/graph_cache.
ProgramCache``) records device work only. Host Python inside it runs
once, at capture: a ``.item()`` or ``.cpu()`` synchronises with the host
(which a capture refuses, and which an eager CPU run hides), a
``.nonzero()`` sizes its output from device data, a ``.numpy()`` or
``np.asarray`` freezes one call's values into every replay, and an
``os.environ`` or ``time.time()`` read is baked in at capture. The
counterpart of the JAX package's pass over ``jax.jit`` code, with the
same rule ids where the meaning carries.

This pass walks every function reachable from a captured program (see
``callgraph.py`` for the roots and what "reachable" means) and flags:

==============================  ============================================
rule                            trigger
==============================  ============================================
``recompile-item``              ``x.item()`` / ``x.tolist()``
``recompile-cast``              ``float(name)`` / ``int(name)`` / ``bool(name)``
                                on a bare name (the classic host-sync cast;
                                shape arithmetic like ``int(x.shape[0])``
                                is deliberately not matched)
``recompile-asarray``           ``np.asarray`` / ``np.array`` /
                                ``numpy.asarray`` / ``numpy.array`` /
                                ``x.numpy()``
``recompile-device-get``        ``x.cpu()`` / ``torch.cuda.synchronize()`` /
                                ``x.nonzero()`` / ``torch.nonzero(x)``
``recompile-time``              ``time.time/monotonic/perf_counter``
``recompile-env``               any ``os.environ`` / ``os.getenv`` touch
==============================  ============================================

All severity *error*; each finding names the root that pulls the
function in. A deliberate host round-trip (a branch only the CPU's eager
run takes) is what the pragma exists for —
``# mlspark-lint: ok recompile-<rule> -- why``.
"""

from __future__ import annotations

import ast

from machine_learning_apache_spark_tpu_torch.analysis.callgraph import (
    FuncInfo,
    build_call_graph,
)
from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Module,
)

__all__ = ["run_recompile", "RULES"]

RULES = {
    "recompile-item": "error",
    "recompile-cast": "error",
    "recompile-asarray": "error",
    "recompile-device-get": "error",
    "recompile-time": "error",
    "recompile-env": "error",
}

_NUMPY_ALIASES = {"np", "numpy", "onp"}
_TIME_FNS = {"time", "monotonic", "perf_counter", "perf_counter_ns"}


def _is_os_environ(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id == "os"
    ) or (isinstance(node, ast.Name) and node.id == "environ")


def _is_torch_cuda(node: ast.AST) -> bool:
    """``torch.cuda`` (or a bare ``cuda``)."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "cuda"
        and isinstance(node.value, ast.Name)
        and node.value.id == "torch"
    ) or (isinstance(node, ast.Name) and node.id == "cuda")


def _hazards_in(info: FuncInfo) -> list[tuple[str, int, str]]:
    """(rule, line, detail) for every hazard lexically inside ``info``."""
    out: list[tuple[str, int, str]] = []
    node = info.node
    body = (
        node.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        else [node.body]
    )
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Call):
                f = n.func
                if isinstance(f, ast.Attribute):
                    base = f.value
                    if f.attr in ("item", "tolist") and not n.args:
                        out.append((
                            "recompile-item", n.lineno,
                            f"`.{f.attr}()` forces a device->host sync",
                        ))
                    elif f.attr == "numpy" and not n.args:
                        out.append((
                            "recompile-asarray", n.lineno,
                            "`.numpy()` copies to the host and freezes one "
                            "call's values into every replay",
                        ))
                    elif (
                        f.attr in ("asarray", "array")
                        and isinstance(base, ast.Name)
                        and base.id in _NUMPY_ALIASES
                    ):
                        out.append((
                            "recompile-asarray", n.lineno,
                            f"`{base.id}.{f.attr}` materializes on host "
                            "and freezes one call's values into every "
                            "replay",
                        ))
                    elif f.attr == "cpu" and not n.args:
                        out.append((
                            "recompile-device-get", n.lineno,
                            "`.cpu()` is a device->host copy and sync",
                        ))
                    elif f.attr == "synchronize" and _is_torch_cuda(base):
                        out.append((
                            "recompile-device-get", n.lineno,
                            "`torch.cuda.synchronize()` is a host sync",
                        ))
                    elif f.attr == "nonzero":
                        out.append((
                            "recompile-device-get", n.lineno,
                            "`nonzero` sizes its output from device data "
                            "(a host sync)",
                        ))
                    elif (
                        f.attr in _TIME_FNS
                        and isinstance(base, ast.Name)
                        and base.id == "time"
                    ):
                        out.append((
                            "recompile-time", n.lineno,
                            f"`time.{f.attr}()` reads the host clock once, "
                            "at capture (baked into every replay)",
                        ))
                    elif f.attr == "getenv" and isinstance(
                        base, ast.Name
                    ) and base.id == "os":
                        out.append((
                            "recompile-env", n.lineno,
                            "`os.getenv` read at capture time",
                        ))
                    elif f.attr == "get" and _is_os_environ(base):
                        out.append((
                            "recompile-env", n.lineno,
                            "`os.environ.get` read at capture time",
                        ))
                elif isinstance(f, ast.Name) and f.id in (
                    "float", "int", "bool"
                ):
                    if len(n.args) == 1 and isinstance(n.args[0], ast.Name):
                        out.append((
                            "recompile-cast", n.lineno,
                            f"`{f.id}({n.args[0].id})` on a device value "
                            "is a host sync",
                        ))
            elif isinstance(n, ast.Subscript) and _is_os_environ(n.value):
                out.append((
                    "recompile-env", n.lineno,
                    "`os.environ[...]` read at capture time",
                ))
    return out


def run_recompile(
    modules: list[Module], config: LintConfig, root: str
) -> list[Finding]:
    graph = build_call_graph(modules)
    roots = graph.program_roots()
    reachable = graph.reachable(roots)
    findings: list[Finding] = []
    for qual, origin in sorted(reachable.items()):
        info = graph.defs[qual]
        for rule, line, detail in _hazards_in(info):
            findings.append(Finding(
                rule=rule,
                severity=RULES[rule],
                path=info.module.path,
                line=line,
                message=(
                    f"{detail} — inside `{qual}`, reachable from a "
                    f"captured program, root {origin}"
                ),
            ))
    return findings
