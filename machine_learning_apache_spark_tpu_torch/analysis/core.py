"""Lint framework core: findings, pragmas, tree loading, config.

The port's copy of ``machine_learning_apache_spark_tpu/analysis/core.py``
(stdlib only): the same findings, pragma grammar and tree loading, with
the port's defaults.

Pragma grammar (suppression is per-rule, never blanket)::

    x = hazard()  # mlspark-lint: ok <rule> [<rule>...] [-- justification]

suppresses findings for the named rule(s) on that physical line. A
pragma on a line of its own applies to the *next* statement line (for
lines too long to carry a trailing comment). ``ok-file <rule>`` anywhere
in the file suppresses the rule file-wide (use sparingly; justify).

The configuration is :class:`LintConfig`'s defaults, the port's own:
every pass, the registry ``machine_learning_apache_spark_tpu_torch/
utils/env.py``, the generated docs ``docs/ENV_TORCH.md``, and
``jit-donate`` a warning. Unlike the JAX package's lint it reads no
``pyproject.toml`` table: the repo's ``[tool.mlspark_lint]`` is the JAX
lint's.
"""

from __future__ import annotations

import ast
import fnmatch
import os
import re
from dataclasses import dataclass, field

__all__ = [
    "Finding",
    "LintConfig",
    "Module",
    "Pragmas",
    "load_tree",
]

PRAGMA_RE = re.compile(
    r"#\s*mlspark-lint:\s*(ok-file|ok)\s+([A-Za-z0-9_,\- ]+?)\s*(?:--.*)?$"
)
HOLDS_RE = re.compile(r"#\s*mlspark-lint:\s*holds\s+(.+?)\s*(?:--.*)?$")
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(\S+)")


@dataclass
class Finding:
    """One rule violation, pointing at a file:line."""

    rule: str
    severity: str  # "error" | "warning"
    path: str
    line: int
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
        }

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}: {self.severity}[{self.rule}]{tag} "
            f"{self.message}"
        )


class Pragmas:
    """Per-file suppression table, parsed once from the source lines."""

    def __init__(self, lines: list[str]):
        #: line number -> set of rule names suppressed on that line
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        for i, text in enumerate(lines, start=1):
            m = PRAGMA_RE.search(text)
            if not m:
                continue
            kind, names = m.group(1), m.group(2)
            rules = {r for r in re.split(r"[,\s]+", names.strip()) if r}
            if kind == "ok-file":
                self.file_wide |= rules
            else:
                # A pragma-only line covers the next line too (long-line
                # escape hatch); a trailing pragma covers its own line.
                target = self.by_line.setdefault(i, set())
                target |= rules
                if text.lstrip().startswith("#"):
                    self.by_line.setdefault(i + 1, set()).update(rules)

    def suppresses(self, rule: str, line: int) -> bool:
        if rule in self.file_wide:
            return True
        return rule in self.by_line.get(line, set())


@dataclass
class Module:
    """One parsed source file."""

    path: str  # as reported in findings (relative to the lint root's cwd)
    name: str  # dotted module name best-effort (for call-graph labels)
    tree: ast.Module
    lines: list[str]
    pragmas: Pragmas

    #: ``# mlspark-lint: holds <lock>`` annotations: line -> lock exprs
    holds: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, rel: str) -> "Module | None":
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError, ValueError):
            return None
        lines = source.splitlines()
        holds: dict[int, set[str]] = {}
        for i, text in enumerate(lines, start=1):
            m = HOLDS_RE.search(text)
            if m:
                holds.setdefault(i, set()).update(
                    s.strip() for s in m.group(1).split(",") if s.strip()
                )
        name = rel[:-3].replace(os.sep, ".") if rel.endswith(".py") else rel
        return cls(
            path=rel, name=name, tree=tree, lines=lines,
            pragmas=Pragmas(lines), holds=holds,
        )

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


@dataclass
class LintConfig:
    passes: list[str] = field(
        default_factory=lambda: ["recompile", "locks", "env", "jit",
                                 "trace"]
    )
    exclude: list[str] = field(default_factory=list)
    env_registry: str = "machine_learning_apache_spark_tpu_torch/utils/env.py"
    env_docs: str = "docs/ENV_TORCH.md"
    #: rule name -> "error"/"warning" overrides
    severity: dict[str, str] = field(
        default_factory=lambda: {"jit-donate": "warning"}
    )

    def excluded(self, rel_path: str) -> bool:
        norm = rel_path.replace(os.sep, "/")
        return any(
            fnmatch.fnmatch(norm, pat) or fnmatch.fnmatch("/" + norm, pat)
            for pat in self.exclude
        )


# -- tree loading -------------------------------------------------------------
def load_tree(paths: list[str], config: LintConfig) -> list[Module]:
    """Parse every ``.py`` under ``paths`` (files or directories) into
    :class:`Module` records, honoring config excludes. Unparseable files
    are skipped (the interpreter will complain louder than we can)."""
    modules: list[Module] = []
    seen: set[str] = set()

    def add(file_path: str) -> None:
        rel = os.path.relpath(file_path)
        if rel in seen or config.excluded(rel):
            return
        seen.add(rel)
        mod = Module.parse(file_path, rel)
        if mod is not None:
            modules.append(mod)

    for p in paths:
        if os.path.isfile(p):
            add(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [
                d for d in sorted(dirnames)
                if d not in ("__pycache__", ".git")
            ]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    add(os.path.join(dirpath, fn))
    return modules
