"""CLI: ``python -m skyplane_tpu_torch.analysis [paths...]`` (also
``skyplane-tpu-torch lint``); with no paths it lints ``skyplane_tpu_torch``.

Human output by default; ``--json FILE`` additionally writes the full
machine-readable report (``chip_smoke.py`` reads it). Exit 0 iff zero
unsuppressed findings — the same predicate the port's gate in
tests/test_torch_analysis.py asserts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from skyplane_tpu_torch.analysis.core import iter_rules, run_paths


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m skyplane_tpu_torch.analysis",
        description="Concurrency + tracer-safety lint for the skyplane_tpu_torch codebase.",
    )
    parser.add_argument("paths", nargs="*", default=["skyplane_tpu_torch"], help="files or directories (default: skyplane_tpu_torch)")
    parser.add_argument("--json", metavar="FILE", help="also write the full findings report as JSON ('-' for stdout)")
    parser.add_argument("--rule", action="append", metavar="RULE", help="only run/report these rules (repeatable)")
    parser.add_argument("--show-suppressed", action="store_true", help="print suppressed findings too")
    parser.add_argument(
        "--check-suppressions",
        action="store_true",
        help="also report stale suppressions (disables whose rule no longer fires on that line)",
    )
    parser.add_argument("--list-rules", action="store_true", help="list every rule with severity and exit")
    parser.add_argument(
        "--no-cache",
        action="store_true",
        help="ignore and do not update the content-hash cache (.sklint-cache-torch.json)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in iter_rules():
            print(f"{rule.name:28s} {rule.severity:8s} {rule.description}")
        return 0

    rules = set(args.rule) if args.rule else None
    if rules:
        known = {r.name for r in iter_rules()}
        bad = rules - known
        if bad:
            parser.error(f"unknown rule(s): {', '.join(sorted(bad))} (see --list-rules)")
    try:
        report = run_paths(
            args.paths or ["skyplane_tpu_torch"],
            rules=rules,
            check_suppressions=args.check_suppressions,
            use_cache=not args.no_cache,
        )
    except FileNotFoundError as e:
        # exit 2 (usage error), distinct from exit 1 (findings): a typo'd
        # path or wrong cwd must fail loudly, never read as a clean gate
        print(f"error: {e}", file=sys.stderr)
        return 2

    shown = report.findings if args.show_suppressed else report.unsuppressed
    for finding in shown:
        print(finding.render())
    n_sup = sum(1 for f in report.findings if f.suppressed)
    cached = " (cached)" if report.cache_info.get("full_hit") else ""
    print(
        f"checked {report.files_checked} files in {report.wall_time_s:.2f}s{cached}: "
        f"{len(report.unsuppressed)} finding(s), {n_sup} suppressed",
        file=sys.stderr,
    )
    if args.json:
        payload = json.dumps(report.as_dict(), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 0 if report.ok() else 1


if __name__ == "__main__":
    sys.exit(main())
