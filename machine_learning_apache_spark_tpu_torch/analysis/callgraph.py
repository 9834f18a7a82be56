"""Best-effort intra-package call graph + captured-program root discovery.

The recompile pass needs "which functions can execute *inside* a
captured program". In the port a program is a CUDA graph
(``utils/graph_cache.ProgramCache``), so the roots are:

- the function handed to a program cache: a call ``programs(name, fn,
  *args)`` whose callee the module binds to a ``ProgramCache`` — a name
  or ``self.<attr>`` assigned ``ProgramCache(...)``, or a parameter or
  variable annotated ``ProgramCache``. ``fn`` (its second argument) is
  the root;
- the functions called in the body of a ``with torch.cuda.graph(...)``
  block. A name bound as a parameter of the enclosing function is not
  resolved: ``graph_cache._Graph`` captures whatever ``fn`` it is handed,
  and what it is handed are the roots above.

Edges are direct calls, resolved conservatively as in the JAX package's
call graph:

- ``f(...)``        -> a def named ``f`` in the same scope/module, or the
  import target when ``f`` was imported;
- ``mod.f(...)``    -> ``f`` in the module ``mod`` aliases;
- ``self.f(...)``   -> method ``f`` of the enclosing class, or, where the
  class has no such method and assigns ``self.f = factory(...)``, the
  nested defs ``factory`` returns by name (``StepDispatch._multi =
  make_multi_step(loss_fn)`` reaches ``make_multi_step``'s
  ``multi_step``).

Unresolvable names fall back to a bare-name match across the package
when the name is rare (<= ``_MAX_FALLBACK`` defs); common names
(``__init__``, ``forward``) are dropped rather than flooding the graph.
Unlike the JAX package's graph, a builtin (``sum(...)``), a parameter of
the calling function (a callable passed in), and an import from outside
the linted tree (``subprocess.run``) resolve to nothing, and an imported
object's method (``LIBRARY.get``) falls back only when its name is rare.
Module indirection (``self.ffn(x)`` calling an ``nn.Module``'s
``forward``) is *not* chased — direct calls are the contract, and root
lambdas/closures are walked in place.
"""

from __future__ import annotations

import ast
import builtins
from dataclasses import dataclass

from machine_learning_apache_spark_tpu_torch.analysis.core import Module

__all__ = ["CallGraph", "FuncInfo", "build_call_graph"]

_MAX_FALLBACK = 8

#: method names never resolved via the cross-class bare fallback: these
#: collide with builtin container / tensor methods (``dict.update``,
#: ``x.view``) and would drag host-side telemetry classes into the
#: reachable set.
_ATTR_FALLBACK_DENY = {
    "set", "get", "update", "add", "append", "extend", "pop", "copy",
    "items", "keys", "values", "split", "join", "mean", "sum", "min",
    "max", "reshape", "astype", "apply", "write", "read", "close",
    "emit", "inc", "dec", "observe", "put", "index", "count", "forward",
    "view", "to", "clone", "detach", "float", "size", "expand", "fill_",
    "copy_", "zero_", "step", "reset", "stats", "state_dict",
    "load_state_dict", "load", "start", "stop", "run", "wait", "search",
    "match", "encode", "decode", "bind", "submit", "result", "release",
    "acquire", "format", "replace", "strip", "find", "sort", "send",
    "device",
}
_BUILTINS = frozenset(dir(builtins))

_CACHE_CLASS = "ProgramCache"
_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass
class FuncInfo:
    """One function/lambda definition in the package."""

    qual: str  # "pkg.mod.Class.name" / "pkg.mod.name" / "...<lambda:42>"
    module: Module
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    cls: str | None = None  # enclosing class bare name
    bare: str = ""


def _is_cache_ctor(node: ast.AST) -> bool:
    """Is this expression a ``ProgramCache(...)`` call?"""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return (isinstance(f, ast.Name) and f.id == _CACHE_CLASS) or (
        isinstance(f, ast.Attribute) and f.attr == _CACHE_CLASS
    )


def _is_cache_annotation(node: ast.AST | None) -> bool:
    """``ProgramCache``, ``mod.ProgramCache`` or ``"ProgramCache"``."""
    if isinstance(node, ast.Name):
        return node.id == _CACHE_CLASS
    if isinstance(node, ast.Attribute):
        return node.attr == _CACHE_CLASS
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(".")[-1] == _CACHE_CLASS
    return False


def is_cuda_graph_expr(node: ast.AST) -> bool:
    """Is this ``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)?"""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == "graph"
        and (
            (isinstance(f.value, ast.Name) and f.value.id == "cuda")
            or (isinstance(f.value, ast.Attribute) and f.value.attr == "cuda")
        )
    )


def _params(fn: ast.AST) -> set[str]:
    if isinstance(fn, (*_FUNC, ast.Lambda)):
        a = fn.args
        names = [p.arg for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]]
        names += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
        return set(names)
    return set()


def _calls_in_value(node: ast.AST) -> list[ast.Call]:
    """The calls an assigned value may evaluate to: ``f(...)``, or each
    call of ``a or f(...)`` / ``f(...) if c else g(...)``."""
    if isinstance(node, ast.Call):
        return [node]
    if isinstance(node, ast.BoolOp):
        return [c for v in node.values for c in _calls_in_value(v)]
    if isinstance(node, ast.IfExp):
        return _calls_in_value(node.body) + _calls_in_value(node.orelse)
    return []


class _ModuleIndex(ast.NodeVisitor):
    """Defs, import aliases, program-cache bindings and ``self.<attr> =
    call`` assignments for one module."""

    def __init__(self, mod: Module, graph: "CallGraph"):
        self.mod = mod
        self.graph = graph
        self.scope: list[str] = []  # class/function name stack
        self.cls: list[str] = []
        self.funcs: list[FuncInfo] = []  # enclosing defs, innermost last

    # -- imports (collected at any scope) ------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            target = alias.name if alias.asname else alias.name.split(".")[0]
            self.graph.imports[self.mod.name][local] = target
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module and node.level == 0:
            for alias in node.names:
                local = alias.asname or alias.name
                self.graph.imports[self.mod.name][local] = (
                    f"{node.module}.{alias.name}"
                )
        self.generic_visit(node)

    # -- program-cache bindings and attribute assignments ---------------------
    def _bind_target(self, target: ast.AST, ctor: ast.Call | None) -> None:
        key = None
        if isinstance(target, ast.Name):
            key = target.id
        elif (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
            and target.value.id == "self"
            and self.cls
        ):
            key = (self.cls[-1], target.attr)
        if key is not None:
            ctors = self.graph.caches[self.mod.name].setdefault(key, [])
            if ctor is not None:
                ctors.append(ctor)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if _is_cache_ctor(node.value):
                self._bind_target(t, node.value)
            elif (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and self.cls
            ):
                enclosing = self.funcs[-1] if self.funcs else None
                for call in _calls_in_value(node.value):
                    self.graph.attr_calls.setdefault(
                        (self.mod.name, self.cls[-1], t.attr), []
                    ).append((call, enclosing))
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if _is_cache_ctor(node.value) or _is_cache_annotation(node.annotation):
            self._bind_target(
                node.target,
                node.value if _is_cache_ctor(node.value) else None,
            )
        self.generic_visit(node)

    # -- defs -----------------------------------------------------------------
    def _add_def(self, node, name: str) -> FuncInfo:
        qual = ".".join([self.mod.name, *self.scope, name])
        info = FuncInfo(
            qual=qual, module=self.mod, node=node,
            cls=self.cls[-1] if self.cls else None, bare=name,
        )
        self.graph.add(info)
        return info

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        info = self._add_def(node, node.name)
        a = node.args
        for p in [*a.posonlyargs, *a.args, *a.kwonlyargs]:
            if _is_cache_annotation(p.annotation):
                self.graph.caches[self.mod.name].setdefault(p.arg, [])
        self.scope.append(node.name)
        self.funcs.append(info)
        self.generic_visit(node)
        self.funcs.pop()
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._add_def(node, f"<lambda:{node.lineno}>")
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.scope.append(node.name)
        self.cls.append(node.name)
        self.generic_visit(node)
        self.cls.pop()
        self.scope.pop()


class CallGraph:
    """Package-wide def index + lazy call-edge resolution."""

    def __init__(self, modules: list[Module]):
        self.modules = modules
        self.defs: dict[str, FuncInfo] = {}
        self.by_bare: dict[str, list[FuncInfo]] = {}
        self.by_class_method: dict[tuple[str, str], list[FuncInfo]] = {}
        self.by_node: dict[int, FuncInfo] = {}
        self.imports: dict[str, dict[str, str]] = {
            m.name: {} for m in modules
        }
        #: module -> binding (a name, or (class, attr) for ``self.attr``)
        #: -> the ``ProgramCache(...)`` calls assigned to it (empty when
        #: only annotated)
        self.caches: dict[str, dict] = {m.name: {} for m in modules}
        #: (module, class, attr) -> [(call assigned to self.attr, the def
        #: it was assigned in)]
        self.attr_calls: dict[tuple[str, str, str], list] = {}
        #: top-level names of the linted tree's modules: an import from
        #: anywhere else is not the package's and resolves to nothing
        self.packages = {m.name.split(".")[0] for m in modules}
        for mod in modules:
            _ModuleIndex(mod, self).visit(mod.tree)
        # ``fn = lambda ...`` bindings: a program may be handed a bound
        # name, so map names to their lambda defs per module.
        self.lambda_binds: dict[str, dict[str, list[FuncInfo]]] = {}
        for mod in modules:
            binds = self.lambda_binds.setdefault(mod.name, {})
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Lambda)
                ):
                    info = self.by_node.get(id(node.value))
                    if info is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            binds.setdefault(t.id, []).append(info)

    def add(self, info: FuncInfo) -> None:
        self.defs[info.qual] = info
        self.by_bare.setdefault(info.bare, []).append(info)
        self.by_node[id(info.node)] = info
        if info.cls:
            self.by_class_method.setdefault(
                (info.cls, info.bare), []
            ).append(info)

    # -- program roots --------------------------------------------------------
    def _scoped(self, mod: Module):
        """Every node of ``mod`` with its enclosing class name and def."""
        def visit(node, cls, fn):
            if isinstance(node, ast.ClassDef):
                cls, fn = node.name, None
            elif isinstance(node, (*_FUNC, ast.Lambda)):
                fn = self.by_node.get(id(node), fn)
            yield node, cls, fn
            for child in ast.iter_child_nodes(node):
                yield from visit(child, cls, fn)

        return visit(mod.tree, None, None)

    def program_calls(self) -> list[tuple[Module, ast.Call, str | None, FuncInfo | None]]:
        """Every program-cache call ``programs(name, fn, *args)`` in the
        package: ``(module, call, enclosing class, enclosing def)``."""
        return [
            (mod, node, cls, fn)
            for mod in self.modules if self.caches.get(mod.name)
            for node, cls, fn in self._scoped(mod)
            if isinstance(node, ast.Call)
            and self._is_program_call(node, self.caches[mod.name], cls)
        ]

    @staticmethod
    def _is_program_call(node: ast.Call, caches: dict, cls: str | None) -> bool:
        f = node.func
        if isinstance(f, ast.Name):
            key = f.id
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and cls is not None
        ):
            key = (cls, f.attr)
        else:
            return False
        return key in caches and len(node.args) >= 2

    def cache_ctors(self, mod: Module, call: ast.Call, cls: str | None) -> list[ast.Call]:
        """The ``ProgramCache(...)`` calls bound to a program call's
        callee in its module (empty when it is only annotated)."""
        f = call.func
        key = f.id if isinstance(f, ast.Name) else (cls, f.attr)
        return self.caches.get(mod.name, {}).get(key, [])

    def target_defs(self, mod: Module, target: ast.AST, enclosing) -> list[FuncInfo]:
        if isinstance(target, ast.Lambda):
            info = self.by_node.get(id(target))
            return [info] if info is not None else []
        found = self.resolve_call(mod, target, enclosing)
        if not found and isinstance(target, ast.Name):
            found = self.lambda_binds.get(mod.name, {}).get(target.id, [])
        return found

    def program_roots(self) -> list[tuple[FuncInfo, str]]:
        """Every function a captured program runs, with the file:line of
        the program call (or of the ``with torch.cuda.graph`` block) that
        makes it one — one entry per (function, site)."""
        roots: list[tuple[FuncInfo, str]] = []
        seen: set[tuple[str, str]] = set()

        def note(info: FuncInfo, where: str) -> None:
            if (info.qual, where) not in seen:
                seen.add((info.qual, where))
                roots.append((info, where))

        for mod, call, _cls, fn in self.program_calls():
            for info in self.target_defs(mod, call.args[1], fn):
                note(info, f"{mod.path}:{call.lineno}")
        for mod in self.modules:
            for node, _cls, enclosing in self._scoped(mod):
                if not isinstance(node, (ast.With, ast.AsyncWith)) or not any(
                    is_cuda_graph_expr(i.context_expr) for i in node.items
                ):
                    continue
                params = _params(enclosing.node) if enclosing else set()
                for stmt in node.body:
                    for n in ast.walk(stmt):
                        if not isinstance(n, ast.Call):
                            continue
                        if isinstance(n.func, ast.Name) and n.func.id in params:
                            continue
                        for info in self.resolve_call(mod, n.func, enclosing):
                            note(info, f"{mod.path}:{node.lineno}")
        return roots

    # -- call resolution ------------------------------------------------------
    def _by_qual_or_bare(self, qual: str) -> list[FuncInfo]:
        if qual in self.defs:
            return [self.defs[qual]]
        if qual.split(".")[0] not in self.packages:
            return []  # a stdlib or third-party callee (``subprocess.run``)
        bare = qual.rsplit(".", 1)[-1]
        if bare in _ATTR_FALLBACK_DENY:
            return []  # an imported object's method (``LIBRARY.get``)
        cands = self.by_bare.get(bare, [])
        if 0 < len(cands) <= _MAX_FALLBACK:
            return cands
        return []

    def _returned_closures(self, factory: FuncInfo) -> list[FuncInfo]:
        """The nested defs ``factory`` returns by name."""
        if not isinstance(factory.node, _FUNC):
            return []
        out = []
        stack = list(factory.node.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (*_FUNC, ast.Lambda, ast.ClassDef)):
                continue  # a nested def's own returns are not the factory's
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Name):
                nested = self.defs.get(f"{factory.qual}.{node.value.id}")
                if nested is not None:
                    out.append(nested)
            stack.extend(ast.iter_child_nodes(node))
        return out

    def _attr_closures(self, mod: Module, cls: str, attr: str) -> list[FuncInfo]:
        """What ``self.<attr>(...)`` calls when the class assigns
        ``self.<attr> = factory(...)``: the closures the factory returns."""
        out = []
        for call, where in self.attr_calls.get((mod.name, cls, attr), []):
            for factory in self.resolve_call(mod, call.func, where):
                out.extend(self._returned_closures(factory))
        return out

    def resolve_call(
        self,
        mod: Module,
        func: ast.AST,
        enclosing: FuncInfo | None,
    ) -> list[FuncInfo]:
        """Candidate definitions for a call expression's func."""
        imports = self.imports.get(mod.name, {})
        if isinstance(func, ast.Name):
            name = func.id
            # module-level def in the same module
            qual = f"{mod.name}.{name}"
            if qual in self.defs:
                return [self.defs[qual]]
            # nested def in the enclosing function
            if enclosing is not None:
                nested = f"{enclosing.qual}.{name}"
                if nested in self.defs:
                    return [self.defs[nested]]
            if name in imports:
                return self._by_qual_or_bare(imports[name])
            if name in _BUILTINS or (
                enclosing is not None and name in _params(enclosing.node)
            ):
                return []  # ``sum(...)``; a callable the caller passed in
            cands = self.by_bare.get(name, [])
            return cands if 0 < len(cands) <= _MAX_FALLBACK else []
        if isinstance(func, ast.Attribute):
            attr = func.attr
            base = func.value
            if isinstance(base, ast.Name):
                if base.id == "self" and enclosing is not None and enclosing.cls:
                    cands = self.by_class_method.get(
                        (enclosing.cls, attr), []
                    )
                    if cands:
                        return cands
                    return self._attr_closures(mod, enclosing.cls, attr)
                if base.id in imports:  # module alias: mod.f(...)
                    return self._by_qual_or_bare(f"{imports[base.id]}.{attr}")
            # obj.method(...): match by method name across known classes,
            # only when rare and not a builtin/tensor method name.
            if attr in _ATTR_FALLBACK_DENY:
                return []
            cands = [
                c for c in self.by_bare.get(attr, []) if c.cls is not None
            ]
            return cands if 0 < len(cands) <= _MAX_FALLBACK else []
        return []

    def reachable(
        self, roots: list[tuple[FuncInfo, str]]
    ) -> dict[str, str]:
        """BFS the call graph from the program roots. Returns
        ``{qual: root_description}`` for every reachable function."""
        out: dict[str, str] = {}
        frontier: list[tuple[FuncInfo, str]] = []
        for info, where in roots:
            if info.qual not in out:
                out[info.qual] = f"`{info.qual}` captured at {where}"
                frontier.append((info, out[info.qual]))
        while frontier:
            info, origin = frontier.pop()
            body = (
                info.node.body
                if isinstance(info.node, _FUNC)
                else [info.node.body]
            )
            for stmt in body:
                for node in ast.walk(stmt):
                    # nested defs/lambdas are walked as part of the outer
                    # function: inside a captured program they are loop
                    # bodies and helpers that run within the capture
                    if isinstance(node, ast.Call):
                        for cand in self.resolve_call(
                            info.module, node.func, enclosing=info
                        ):
                            if cand.qual not in out:
                                out[cand.qual] = origin
                                frontier.append((cand, origin))
        return out


def build_call_graph(modules: list[Module]) -> CallGraph:
    return CallGraph(modules)
