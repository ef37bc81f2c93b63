"""CLI of the port's `dllama-analyze`: ``python -m distributed_llama_tpu_torch.analysis``.

Exit codes: 0 = clean (after noqa + baseline), 1 = findings at or above
``--fail-level``, 2 = usage or internal error. ``--write-baseline``
snapshots the current findings as grandfathered and exits 0 — the
intended workflow keeps that file empty (docs/ANALYSIS.md). The
configuration is the package's ``analysis.toml`` unless ``--config`` names
another.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .config import load_config
from .engine import SEVERITIES, analyze, write_baseline
from .rules import all_rules, rule_ids


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_llama_tpu_torch.analysis",
        description="AST rule engine enforcing this repo's donation, "
        "lock-discipline and telemetry invariants (docs/ANALYSIS.md)",
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files or directories to scan (default: the installed "
        "distributed_llama_tpu_torch package directory)",
    )
    p.add_argument(
        "--select",
        default="",
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    p.add_argument(
        "--config",
        default=None,
        help="an analysis.toml (default: the package's own)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help="baseline file overriding the configured one",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="report findings even when baselined",
    )
    p.add_argument(
        "--write-baseline",
        action="store_true",
        help="snapshot current findings into the baseline file and exit 0",
    )
    p.add_argument(
        "--fail-level",
        choices=SEVERITIES,
        default="warning",
        help="minimum severity that fails the run (default: warning — "
        "every finding fails, which is what CI wants)",
    )
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  [{rule.severity}]  {rule.short}")
        return 0

    paths = args.paths or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    for path in paths:
        if not os.path.exists(path):
            print(f"error: no such path: {path}", file=sys.stderr)
            return 2

    try:
        config = load_config(args.config)
    except Exception as e:  # a malformed configuration is a usage error, not a crash
        print(f"error: could not load configuration: {e}", file=sys.stderr)
        return 2
    if args.baseline is not None:
        config.baseline = args.baseline

    select = {s.strip() for s in args.select.split(",") if s.strip()}
    if select:
        unknown = {s.upper() for s in select} - set(rule_ids())
        if unknown:
            print(
                f"error: unknown rule id(s): {', '.join(sorted(unknown))}",
                file=sys.stderr,
            )
            return 2
    rules = all_rules(select or None)

    if args.write_baseline:
        if not config.baseline:
            print(
                "error: --write-baseline needs a baseline path (config"
                " `baseline` is empty; pass --baseline PATH)",
                file=sys.stderr,
            )
            return 2
        findings, _ = analyze(paths, config, rules=rules, use_baseline=False)
        target = config.rel_to_root(config.baseline)
        pruned = write_baseline(target, findings)
        print(
            f"wrote {len(findings)} fingerprint(s) to {target}"
            f" ({pruned} stale fingerprint(s) pruned)"
        )
        return 0

    findings, stats = analyze(
        paths, config, rules=rules, use_baseline=not args.no_baseline
    )
    failing = [
        f
        for f in findings
        if SEVERITIES.index(f.severity) >= SEVERITIES.index(args.fail_level)
    ]

    if args.fmt == "json":
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        summary = (
            f"{len(findings)} finding(s) in {stats['files']} file(s)"
            f" ({stats['suppressed']} noqa-suppressed,"
            f" {stats['baselined']} baselined)"
        )
        print(("FAIL: " if failing else "OK: ") + summary)
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
