#!/usr/bin/env python
"""mlspark-lint for the PyTorch/CUDA port — repo-native static analysis.

Usage::

    python tools/torch_mlspark_lint.py [paths...] [--json] [--passes a,b]
    python tools/torch_mlspark_lint.py --write-env-docs

Defaults to linting ``machine_learning_apache_spark_tpu_torch`` with
every pass, against the port's env registry and ``docs/ENV_TORCH.md``
(``analysis.core.LintConfig``'s defaults; the repo's pyproject table is
the JAX lint's). Exit code 1 iff any unsuppressed error-severity finding
remains.

The port's package ``__init__`` loads nothing at import, so the analysis
package imports without torch: the whole run is stdlib-only, cheap
enough for the tier-1 subprocess gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = "machine_learning_apache_spark_tpu_torch"


def _import_analysis():
    sys.path.insert(0, REPO_ROOT)
    import machine_learning_apache_spark_tpu_torch.analysis as analysis
    return analysis


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="torch_mlspark_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "paths", nargs="*", default=None,
        help=f"files/dirs to lint (default: {_PKG})",
    )
    ap.add_argument(
        "--root", default=REPO_ROOT,
        help="root the registry and docs paths are relative to (default: auto)",
    )
    ap.add_argument(
        "--passes", default=None,
        help="comma-separated subset of passes to run",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="machine-readable findings on stdout",
    )
    ap.add_argument(
        "--show-suppressed", action="store_true",
        help="also print pragma-suppressed findings",
    )
    ap.add_argument(
        "--write-env-docs", action="store_true",
        help="regenerate docs/ENV_TORCH.md from the registry and exit",
    )
    args = ap.parse_args(argv)

    analysis = _import_analysis()
    root = os.path.abspath(args.root)
    os.chdir(root)  # findings report paths relative to the repo root
    config = analysis.LintConfig()

    if args.write_env_docs:
        from machine_learning_apache_spark_tpu_torch.analysis.envcheck import (
            extract_registry,
            render_markdown,
        )
        entries = extract_registry(os.path.join(root, config.env_registry))
        docs_path = os.path.join(root, config.env_docs)
        os.makedirs(os.path.dirname(docs_path), exist_ok=True)
        with open(docs_path, "w", encoding="utf-8") as f:
            f.write(render_markdown(entries))
        print(f"wrote {config.env_docs} ({len(entries)} variables)")
        return 0

    paths = args.paths or [_PKG]
    passes = (
        [p.strip() for p in args.passes.split(",") if p.strip()]
        if args.passes else None
    )
    findings = analysis.run_lint(paths, root, config=config, passes=passes)

    active = [f for f in findings if not f.suppressed]
    errors = [f for f in active if f.severity == "error"]
    if args.json:
        print(json.dumps(
            {
                "findings": [f.to_dict() for f in findings],
                "counts": {
                    "error": len(errors),
                    "warning": len(active) - len(errors),
                    "suppressed": len(findings) - len(active),
                },
            },
            indent=2,
        ))
    else:
        shown = findings if args.show_suppressed else active
        for f in shown:
            print(f.render())
        print(
            f"mlspark-lint: {len(errors)} error(s), "
            f"{len(active) - len(errors)} warning(s), "
            f"{len(findings) - len(active)} suppressed"
        )
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
