"""Pass ``env`` — the ``MLSPARK_*`` environment contract.

The port's copy of the JAX package's pass, with the same rules, held to
the port's registry and docs (``LintConfig``'s defaults).

``utils/env.py`` is the single registry of every environment variable
the framework reads or writes: name, type, default, subsystem, one-line
description. The registry entries are *pure literals* precisely so this
pass can extract them with ``ast`` — no package import, no torch.

Rules:

- ``env-direct-read`` (error): an ``os.environ`` / ``os.getenv`` access
  (read, write, or ``in`` test) whose key is a ``MLSPARK_*`` literal or
  a module constant bound to one, anywhere outside the registry module.
  Use ``utils.env.get_*`` / ``raw`` / ``is_set`` / ``put_into`` instead.
- ``env-unregistered`` (error): a ``"MLSPARK_*"`` string literal that
  names a variable missing from the registry. Literals ending in ``_``
  are prefix families (``ConfigBase.from_env(prefix="MLSPARK_")``) and
  are exempt.
- ``env-docs-drift`` (error): ``docs/ENV_TORCH.md`` does not match what
  the registry would generate. Fix with ``tools/torch_mlspark_lint.py
  --write-env-docs``.
"""

from __future__ import annotations

import ast
import os
import re

from machine_learning_apache_spark_tpu_torch.analysis.core import (
    Finding,
    LintConfig,
    Module,
)

__all__ = [
    "RULES",
    "EnvEntry",
    "extract_registry",
    "render_markdown",
    "run_env",
]

RULES = {
    "env-direct-read": "error",
    "env-unregistered": "error",
    "env-docs-drift": "error",
}


class EnvEntry:
    """One ``register(...)`` call, AST-extracted."""

    def __init__(self, name, type_, default, subsystem, description,
                 choices, line):
        self.name = name
        self.type = type_
        self.default = default
        self.subsystem = subsystem
        self.description = description
        self.choices = choices
        self.line = line


def _literal(node: ast.AST):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return None


def extract_registry(registry_path: str) -> list[EnvEntry]:
    """Parse ``utils/env.py`` and pull every literal ``register()``
    call. Raises ``OSError`` if the file is unreadable — a missing
    registry is a configuration error, not a clean tree."""
    with open(registry_path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=registry_path)
    entries: list[EnvEntry] = []
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "register"
        ):
            continue
        name = _literal(node.args[0]) if node.args else None
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        if not isinstance(name, str):
            continue
        entries.append(EnvEntry(
            name=name,
            type_=_literal(kw.get("type")) or "str",
            default=_literal(kw.get("default")),
            subsystem=_literal(kw.get("subsystem")) or "core",
            description=_literal(kw.get("description")) or "",
            choices=_literal(kw.get("choices")),
            line=node.lineno,
        ))
    return entries


def render_markdown(entries: list[EnvEntry]) -> str:
    """docs/ENV_TORCH.md content — generated, grouped by subsystem. The drift
    rule compares this byte-for-byte against the checked-in file."""
    out = [
        "# Environment variables",
        "",
        "<!-- GENERATED by tools/torch_mlspark_lint.py --write-env-docs"
        " — do not edit by hand. -->",
        "",
        "Every `MLSPARK_*` variable the PyTorch/CUDA port reads or"
        " writes, from its central",
        "registry in"
        " [`utils/env.py`](../machine_learning_apache_spark_tpu_torch/utils/env.py).",
        "Code must access these through `utils.env` accessors"
        " (`get_str`, `get_int`,",
        "`get_bool`, `raw`, `is_set`, `put_into`) — the `env` lint pass"
        " flags direct",
        "`os.environ` reads of registered names.",
        "",
    ]
    by_sub: dict[str, list[EnvEntry]] = {}
    for e in entries:
        by_sub.setdefault(e.subsystem, []).append(e)
    for sub in sorted(by_sub):
        out.append(f"## {sub}")
        out.append("")
        out.append("| variable | type | default | description |")
        out.append("| --- | --- | --- | --- |")
        for e in sorted(by_sub[sub], key=lambda e: e.name):
            default = "(unset)" if e.default is None else f"`{e.default!r}`"
            desc = e.description
            if e.choices:
                opts = ", ".join(f"`{c}`" for c in e.choices)
                desc = f"{desc} One of: {opts}."
            out.append(
                f"| `{e.name}` | {e.type} | {default} | {desc} |"
            )
        out.append("")
    return "\n".join(out).rstrip() + "\n"


_ENV_PREFIX = "MLSPARK_"
_NAME_RE = re.compile(r"MLSPARK_[A-Z0-9_]+")


def _os_aliases(mod: Module) -> set[str]:
    """Local names bound to the ``os`` module (``import os as _os``)."""
    names = {"os"}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "os" and alias.asname:
                    names.add(alias.asname)
    return names


def _is_environ_expr(node: ast.AST, os_names: set[str]) -> bool:
    """``os.environ`` (any os alias) or a bare ``environ`` (from-import)."""
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "environ"
        and isinstance(node.value, ast.Name)
        and node.value.id in os_names
    ) or (isinstance(node, ast.Name) and node.id == "environ")


def _module_env_constants(mod: Module) -> dict[str, str]:
    """Module-level ``ENV_FOO = "MLSPARK_FOO"`` constants."""
    out: dict[str, str] = {}
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(
            stmt.value, ast.Constant
        ) and isinstance(stmt.value.value, str) and stmt.value.value.startswith(
            _ENV_PREFIX
        ):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value.value
    return out


def _key_of(node: ast.AST, consts: dict[str, str]) -> str | None:
    """The MLSPARK_* name an env-access key expression refers to."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value.startswith(_ENV_PREFIX) else None
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


def run_env(
    modules: list[Module], config: LintConfig, root: str
) -> list[Finding]:
    findings: list[Finding] = []
    registry_path = os.path.join(root, config.env_registry)
    registry_rel = config.env_registry.replace("/", os.sep)
    try:
        entries = extract_registry(registry_path)
    except (OSError, SyntaxError):
        return [Finding(
            rule="env-docs-drift", severity="error",
            path=config.env_registry, line=1,
            message=f"env registry not readable at {registry_path}",
        )]
    registered = {e.name for e in entries}

    for mod in modules:
        norm = mod.path.replace("/", os.sep)
        if norm.endswith(registry_rel):
            continue
        consts = _module_env_constants(mod)
        os_names = _os_aliases(mod)

        def note(rule: str, line: int, msg: str) -> None:
            findings.append(Finding(
                rule=rule, severity=RULES[rule],
                path=mod.path, line=line, message=msg,
            ))

        for node in ast.walk(mod.tree):
            key = None
            how = None
            if isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "getenv"
                    and isinstance(f.value, ast.Name)
                    and f.value.id in os_names
                ) and node.args:
                    key = _key_of(node.args[0], consts)
                    how = "os.getenv"
                elif (
                    isinstance(f, ast.Attribute)
                    and f.attr in ("get", "setdefault", "pop")
                    and _is_environ_expr(f.value, os_names)
                ) and node.args:
                    key = _key_of(node.args[0], consts)
                    how = f"os.environ.{f.attr}"
            elif isinstance(node, ast.Subscript) and _is_environ_expr(
                node.value, os_names
            ):
                key = _key_of(node.slice, consts)
                how = "os.environ[...]"
            elif isinstance(node, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
            ) and node.comparators and _is_environ_expr(
                node.comparators[0], os_names
            ):
                key = _key_of(node.left, consts)
                how = "`in os.environ`"
            if key is not None:
                note(
                    "env-direct-read", node.lineno,
                    f"{how} access to `{key}` bypasses the env registry"
                    " — use utils.env accessors (get_str/get_int/"
                    "get_bool/raw/is_set/put_into)",
                )

            # unregistered literals (prefix families exempt; prose that
            # merely mentions a variable — log messages, docstrings — is
            # not a bare NAME literal and is exempt too)
            if (
                isinstance(node, ast.Constant)
                and isinstance(node.value, str)
                and _NAME_RE.fullmatch(node.value)
                and not node.value.endswith("_")
                and node.value not in registered
            ):
                note(
                    "env-unregistered", node.lineno,
                    f"`{node.value}` is not declared in the env registry"
                    f" ({config.env_registry}) — register it with name,"
                    " type, default, subsystem, description",
                )

    # -- docs drift -----------------------------------------------------------
    docs_path = os.path.join(root, config.env_docs)
    want = render_markdown(entries)
    try:
        with open(docs_path, encoding="utf-8") as f:
            have = f.read()
    except OSError:
        have = None
    if have != want:
        findings.append(Finding(
            rule="env-docs-drift", severity=RULES["env-docs-drift"],
            path=config.env_docs, line=1,
            message=(
                f"{config.env_docs} is "
                + ("missing" if have is None else "stale")
                + " — regenerate with `python tools/torch_mlspark_lint.py"
                " --write-env-docs`"
            ),
        ))
    return findings
