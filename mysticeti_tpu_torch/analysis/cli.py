"""Command-line front end: ``python -m mysticeti_tpu_torch.analysis`` (and
the ``python -m mysticeti_tpu_torch.tools.lint`` alias).

The default path is the whole ``mysticeti_tpu_torch`` package, its
``tools/`` and ``bench.py`` included (the JAX package keeps those at the
repository root, outside its lint's default path).

Exit codes: 0 = clean (no new findings beyond the baseline), 1 = new
findings, 2 = usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from .checker import (
    RULES,
    analyze_paths,
    load_baseline,
    new_findings,
    write_baseline,
)

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PACKAGE_ROOT)
DEFAULT_BASELINE = os.path.join(
    _PACKAGE_ROOT, "analysis", "baseline.json"
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m mysticeti_tpu_torch.analysis",
        description=(
            "mysticeti-lint: AST invariant checker (async-safety, lock "
            "discipline, JAX kernel purity, wall-clock use, metrics labels)"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files/directories to analyze (default: the mysticeti_tpu_torch package)",
    )
    parser.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help="baseline file of tolerated findings (default: analysis/baseline.json)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding; ignore the baseline",
    )
    parser.add_argument(
        "--baseline-regen",
        action="store_true",
        help="rewrite the baseline from the current findings and exit 0",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit findings as JSON (alias for --format json)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default=None,
        help="output format (sarif = SARIF 2.1.0 for CI/editor ingestion)",
    )
    parser.add_argument(
        "--changed",
        action="store_true",
        help=(
            "report only findings in files changed vs git HEAD (staged, "
            "unstaged, or untracked); the analysis itself still runs "
            "repo-wide so cross-file rules stay sound"
        ),
    )
    parser.add_argument(
        "--jobs",
        type=int,
        default=None,
        metavar="N",
        help="worker processes for the per-file pass (default: auto; 1 = serial)",
    )
    parser.add_argument(
        "--no-cache",
        action="store_true",
        help="ignore and do not write the per-file result cache (.lint-cache-torch.json)",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print rule ids and exit"
    )
    return parser


def _git_changed_files(repo: str) -> Optional[set]:
    """Repo-relative paths changed vs HEAD (staged+unstaged+untracked);
    None when git is unavailable (caller falls back to unfiltered)."""
    import subprocess

    changed: set = set()
    for cmd in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                cmd, cwd=repo, capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        changed.update(
            line.strip() for line in proc.stdout.splitlines() if line.strip()
        )
    return changed


def _to_sarif(findings) -> dict:
    return {
        "version": "2.1.0",
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "mysticeti-lint",
                        "informationUri": "docs/static-analysis.md",
                        "rules": [{"id": rule} for rule in RULES],
                    }
                },
                "results": [
                    {
                        "ruleId": f.rule,
                        "level": "error",
                        "message": {"text": f.message},
                        "locations": [
                            {
                                "physicalLocation": {
                                    "artifactLocation": {"uri": f.path},
                                    "region": {
                                        "startLine": max(1, f.line),
                                        "startColumn": f.col + 1,
                                    },
                                }
                            }
                        ],
                    }
                    for f in findings
                ],
            }
        ],
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            print(rule)
        return 0

    fmt = args.format or ("json" if args.as_json else "text")

    paths: List[str] = list(args.paths) or [_PACKAGE_ROOT]
    for path in paths:
        if not os.path.exists(path):
            print(f"error: no such path: {path}", file=sys.stderr)
            return 2

    findings = analyze_paths(
        paths,
        root=_REPO_ROOT,
        jobs=args.jobs,
        use_cache=not args.no_cache,
    )

    if args.baseline_regen:
        write_baseline(args.baseline, findings)
        print(
            f"baseline regenerated with {len(findings)} finding(s) -> "
            f"{os.path.relpath(args.baseline, _REPO_ROOT)}"
        )
        return 0

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    fresh = new_findings(findings, baseline)

    if args.changed:
        changed = _git_changed_files(_REPO_ROOT)
        if changed is None:
            print(
                "warning: --changed requested but git diff failed; "
                "reporting all findings",
                file=sys.stderr,
            )
        else:
            fresh = [f for f in fresh if f.path in changed]

    if fmt == "sarif":
        print(json.dumps(_to_sarif(fresh), indent=2))
    elif fmt == "json":
        print(
            json.dumps(
                [
                    {
                        "rule": f.rule,
                        "path": f.path,
                        "line": f.line,
                        "col": f.col,
                        "message": f.message,
                    }
                    for f in fresh
                ],
                indent=2,
            )
        )
    else:
        for f in fresh:
            print(f.render())
        baselined = len(findings) - len(fresh)
        tail = f" ({baselined} baselined)" if baselined else ""
        print(
            f"mysticeti-lint: {len(fresh)} new finding(s) over "
            f"{len(paths)} path(s){tail}"
        )
    return 1 if fresh else 0
