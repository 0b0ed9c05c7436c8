"""The port's tpulint CLI: run the rules over flink_ml_tpu_torch/.

Port of scripts/tpulint.py. Usage, from the repository root:

  python -m flink_ml_tpu_torch.analysis                # every rule, whole package
  python -m flink_ml_tpu_torch.analysis --changed      # report only files that
                                                       # differ from HEAD; rules
                                                       # over the whole project
                                                       # still see the whole tree
  python -m flink_ml_tpu_torch.analysis --list-rules   # the rule catalogue
  python -m flink_ml_tpu_torch.analysis --rule host-sync-leak [--rule ...]
  python -m flink_ml_tpu_torch.analysis path/to/file.py [...]
  python -m flink_ml_tpu_torch.analysis --show-suppressed   # also what suppressions hid
  python -m flink_ml_tpu_torch.analysis --format json       # file/line/rule/message/chain
  python -m flink_ml_tpu_torch.analysis --format sarif      # SARIF 2.1.0
  --changed uses the incremental summary cache (.tpulint_torch_cache.json):
  unchanged modules' call-graph walks are read back instead of run;
  --no-cache forces a cold pass, --cache warms it on a full run.

Exit status: 0 when no finding is left unsuppressed, 1 otherwise.
Suppress a deliberate finding with an inline (or preceding-line) comment:

    # tpulint: disable=<rule-id> -- <reason>

Unused suppressions are themselves findings (unused-suppression).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

from . import engine


def _changed_files(root: str):
    """Repo-relative .py files differing from HEAD (staged, unstaged and
    untracked). A renamed file is linted at its new path; a deleted one is
    skipped. None when `root` is not a git checkout with a HEAD: the caller
    lints the whole tree instead."""

    def git(*args):
        return subprocess.run(
            ["git", *args], cwd=root, capture_output=True, text=True
        )

    # -M: rename detection, so a renamed file is one R row (new path),
    # not a D row for a path that exists only in HEAD plus an A row
    diff = git("diff", "--name-status", "-M", "HEAD")
    untracked = git("ls-files", "--others", "--exclude-standard")
    if diff.returncode != 0 or untracked.returncode != 0:
        return None
    candidates = []
    for line in diff.stdout.splitlines():
        parts = line.split("\t")
        if len(parts) < 2:
            continue
        status = parts[0].strip()
        if status.startswith("D"):
            continue  # deleted: exists only in HEAD, nothing to lint
        # R<score>/C<score> rows are "old<TAB>new": lint the new path
        candidates.append(parts[-1].strip())
    candidates.extend(line.strip() for line in untracked.stdout.splitlines())
    files = []
    for rel in candidates:
        if rel.endswith(".py") and os.path.exists(os.path.join(root, rel)):
            files.append(rel)
    return sorted(set(files))


def _chain_of(finding) -> list:
    """The interprocedural call chain a finding carries, when any (the
    host-sync laundering chain)."""
    data = getattr(finding, "data", ()) or ()
    if data and isinstance(data[0], str):
        if data[0].endswith("-chain"):
            return [str(x) for x in data[2:]]
    return []


def _finding_json(finding) -> dict:
    return {
        "file": finding.path,
        "line": finding.line,
        "rule": finding.rule,
        "message": finding.message,
        "chain": _chain_of(finding),
    }


def _sarif_result(finding, suppressed: bool) -> dict:
    result = {
        "ruleId": finding.rule,
        "level": "error",
        "message": {"text": finding.message},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(1, int(finding.line))},
                }
            }
        ],
    }
    if suppressed:
        # in-source suppressions map onto SARIF's suppression object, so
        # viewers show the census without failing the run
        result["suppressions"] = [{"kind": "inSource"}]
    return result


def _sarif_report(report) -> dict:
    """SARIF 2.1.0: one run, the rule catalogue as driver metadata, every
    finding (and suppressed census entry) as a result."""
    rules_meta = []
    for rule in engine.all_rules():
        rules_meta.append(
            {
                "id": rule.id,
                "name": rule.id,
                "shortDescription": {"text": rule.title},
                "fullDescription": {"text": rule.rationale},
                "defaultConfiguration": {"level": "error"},
            }
        )
    rules_meta.append(
        {
            "id": engine.UNUSED_SUPPRESSION,
            "name": engine.UNUSED_SUPPRESSION,
            "shortDescription": {
                "text": "a tpulint suppression that matches no finding"
            },
            "defaultConfiguration": {"level": "error"},
        }
    )
    return {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
            "Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "tpulint",
                        "informationUri": "flink_ml_tpu_torch/analysis/__init__.py",
                        "rules": rules_meta,
                    }
                },
                "results": [
                    _sarif_result(f, suppressed=False) for f in report.findings
                ]
                + [_sarif_result(f, suppressed=True) for f in report.suppressed],
            }
        ],
    }


def _list_rules() -> int:
    for rule in engine.all_rules():
        print(f"{rule.id}: {rule.title}")
        print(f"  scope: {', '.join(rule.scope)}")
        for line in textwrap.wrap(rule.rationale, width=74):
            print(f"  {line}")
        if rule.example:
            for line in rule.example.splitlines():
                print(f"  e.g. {line}")
        print()
    print(
        f"{engine.UNUSED_SUPPRESSION}: a `# tpulint: disable=` comment that "
        "matches no finding\n  (built-in; stale annotations rot the audit "
        "trail and are errors)"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m flink_ml_tpu_torch.analysis",
        description="flink_ml_tpu_torch static analysis"
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="repo-relative files to report on (default: whole package)",
    )
    parser.add_argument(
        "--changed",
        action="store_true",
        help="report only files differing from HEAD (fast pre-commit mode)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        dest="rules",
        metavar="RULE_ID",
        help="run only the given rule id (repeatable)",
    )
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print findings hidden by suppressions (the sync census)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
        help="output format: json emits one machine-readable object "
        "(findings + suppressed census, each with file/line/rule/chain); "
        "sarif emits SARIF 2.1.0 for CI PR annotation",
    )
    parser.add_argument(
        "--no-cache",
        action="store_true",
        help="skip the incremental summary cache (.tpulint_torch_cache.json) "
        "that --changed uses to serve clean modules' call-graph analyses "
        "from disk",
    )
    parser.add_argument(
        "--cache",
        action="store_true",
        help="use (and refresh) the summary cache on a full run too, "
        "warming it for the next --changed pass",
    )
    parser.add_argument(
        "--root",
        default=None,
        help="lint a different tree root (fixture trees in tests; the "
        "scanned scope is still <root>/flink_ml_tpu_torch)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        return _list_rules()

    root = os.path.abspath(args.root) if args.root else engine.REPO_ROOT
    rules = None
    if args.rules:
        known = {r.id for r in engine.all_rules()}
        for rule_id in args.rules:
            if rule_id not in known:
                parser.error(
                    f"unknown rule {rule_id!r} (see --list-rules)"
                )
        rules = [engine.get_rule(rule_id) for rule_id in args.rules]

    only_paths = None
    if args.changed:
        only_paths = _changed_files(root)
        if only_paths is None:
            print(
                "tpulint: --changed needs a git checkout with a HEAD; "
                "linting the whole tree instead",
                file=sys.stderr,
            )
        elif not only_paths:
            if args.format == "json":
                print(json.dumps({"clean": True, "findings": [], "suppressed": []}))
            elif args.format == "sarif":
                print(json.dumps(_sarif_report(engine.Report()), indent=2))
            else:
                print("tpulint: no files differ from HEAD")
            return 0
    if args.paths:
        normalized = [
            os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")
            for p in args.paths
        ]
        only_paths = (
            normalized
            if only_paths is None
            else sorted(set(only_paths) & set(normalized))
        )

    summary_cache = None
    if not args.no_cache and (args.changed or args.cache):
        from . import cache as _cache

        summary_cache = _cache.SummaryCache.load(_cache.cache_path(root))

    report = engine.run(
        root=root, rules=rules, only_paths=only_paths, summary_cache=summary_cache
    )
    if summary_cache is not None:
        print(
            f"tpulint: summary cache {len(summary_cache.servable)} clean / "
            f"{len(summary_cache.dirty)} dirty module(s), "
            f"{summary_cache.hits} analyses served",
            file=sys.stderr,
        )

    if args.format == "sarif":
        print(json.dumps(_sarif_report(report), indent=2))
        return report.exit_code

    if args.format == "json":
        print(
            json.dumps(
                {
                    "clean": not report.findings,
                    "findings": [_finding_json(f) for f in report.findings],
                    "suppressed": [_finding_json(f) for f in report.suppressed],
                },
                indent=2,
            )
        )
        return report.exit_code

    if args.show_suppressed and report.suppressed:
        print(f"-- {len(report.suppressed)} suppressed finding(s):")
        for finding in report.suppressed:
            print(f"   {finding.format()}")
    for finding in report.findings:
        print(finding.format())
    if report.findings:
        print(
            f"tpulint: {len(report.findings)} finding(s) "
            f"({len(report.suppressed)} suppressed)"
        )
        return 1
    print(
        f"tpulint: clean ({len(report.suppressed)} suppressed finding(s)"
        "; run --show-suppressed for the census)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
