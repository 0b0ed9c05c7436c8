"""The port's tpulint engine: the rule registry, the project scan and
suppression resolution.

Port of flink_ml_tpu/analysis/engine.py. A rule is a subclass of `Rule`
registered with `register`. It declares its identity and documentation
as class attributes and yields `Finding`s from `check_project`
(project-wide rules) or `check_module` (per-file rules, called once per
file in its `scope`).

The engine:

1. walks `flink_ml_tpu_torch/`, one `SourceModule` a file;
2. runs every rule over the modules in its scope;
3. drops a finding covered by a `# tpulint: disable=<rule>` suppression
   on its line, and marks that suppression used;
4. reports every unused suppression as a finding of the built-in
   `unused-suppression` rule: a stale annotation misstates the code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Type

from .source import SourceModule

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
#: the package the port lints
PACKAGE = "flink_ml_tpu_torch"
DEFAULT_SCOPE = (PACKAGE,)

UNUSED_SUPPRESSION = "unused-suppression"


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file:line."""

    path: str  # repo-relative
    line: int
    rule: str
    message: str
    data: Tuple = ()  # structured payload for shims/tests (rule-specific)

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


class Rule:
    """Base class of the rules. Subclasses set the metadata attributes and
    override one of the check hooks."""

    id: str = ""
    title: str = ""
    rationale: str = ""  # the WHY, rendered by --list-rules and the docs
    example: str = ""  # a minimal offending snippet
    scope: Tuple[str, ...] = DEFAULT_SCOPE  # repo-relative path prefixes
    exclude: Tuple[str, ...] = ()  # repo-relative path prefixes to skip

    def applies_to(self, path: str) -> bool:
        path = path.replace("\\", "/")
        if not any(
            path == p or path.startswith(p.rstrip("/") + "/") for p in self.scope
        ):
            return False
        return not any(
            path == p or path.startswith(p.rstrip("/") + "/") for p in self.exclude
        )

    def check_project(self, project: "Project") -> Iterable[Finding]:
        for module in project.modules:
            if self.applies_to(module.path):
                yield from self.check_module(project, module)

    def check_module(
        self, project: "Project", module: SourceModule
    ) -> Iterable[Finding]:
        return ()


_REGISTRY: Dict[str, Rule] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a rule (as a singleton instance) to the
    registry. Rule ids must be unique."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _REGISTRY[cls.id] = cls()
    return cls


def all_rules() -> List[Rule]:
    _load_rules()
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def get_rule(rule_id: str) -> Rule:
    _load_rules()
    return _REGISTRY[rule_id]


def _load_rules() -> None:
    from . import rules  # noqa: F401  (imports register every rule module)


@dataclass
class Project:
    """The scanned tree plus lazily-built cross-module indexes."""

    root: str
    modules: List[SourceModule] = field(default_factory=list)
    _by_path: Dict[str, SourceModule] = field(default_factory=dict)
    _by_module_name: Dict[str, SourceModule] = field(default_factory=dict)
    _indexes: Dict[str, Any] = field(default_factory=dict)
    #: prepared analysis.cache.SummaryCache (incremental lint), or None
    summary_cache: Any = None

    @classmethod
    def load(
        cls, root: str = REPO_ROOT, scope: Sequence[str] = DEFAULT_SCOPE
    ) -> "Project":
        project = cls(root=root)
        for prefix in scope:
            base = os.path.join(root, prefix)
            if os.path.isfile(base):
                project.add(SourceModule.load(base, os.path.relpath(base, root)))
                continue
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = sorted(
                    d for d in dirnames if d != "__pycache__"
                )
                for fname in sorted(filenames):
                    if not fname.endswith(".py"):
                        continue
                    abspath = os.path.join(dirpath, fname)
                    project.add(
                        SourceModule.load(abspath, os.path.relpath(abspath, root))
                    )
        return project

    def add(self, module: SourceModule) -> None:
        if module.path in self._by_path:
            return
        self.modules.append(module)
        self._by_path[module.path] = module
        if module.module_name:
            self._by_module_name[module.module_name] = module

    def module_at(self, path: str) -> Optional[SourceModule]:
        return self._by_path.get(path.replace("\\", "/"))

    def module_named(self, dotted: str) -> Optional[SourceModule]:
        return self._by_module_name.get(dotted)

    def index(self, key: str, build) -> Any:
        """Memoized cross-module index (e.g. the program-funnel index the
        host-sync and resident-program rules share)."""
        if key not in self._indexes:
            self._indexes[key] = build(self)
        return self._indexes[key]


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)  # unsuppressed
    suppressed: List[Finding] = field(default_factory=list)

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def run(
    root: str = REPO_ROOT,
    scope: Sequence[str] = DEFAULT_SCOPE,
    rules: Optional[Sequence[Rule]] = None,
    only_paths: Optional[Sequence[str]] = None,
    project: Optional[Project] = None,
    summary_cache: Any = None,
) -> Report:
    """Run `rules` (default: all registered) over the tree.

    `only_paths` filters the *reported* findings to the given
    repo-relative files (the `--changed` path); project-wide rules still
    see the whole tree, so a partial lint cannot dodge a cross-file rule.

    `summary_cache` (analysis.cache.SummaryCache) serves the call-graph
    analyses of modules proven unchanged by content hash (less the
    reverse-import closure of the changed ones) and is refreshed from this
    run afterwards; events are cached with the summaries, so a warm run
    gives the findings of a cold one.
    """
    if project is None:
        project = Project.load(root=root, scope=scope)
    if rules is None:
        rules = all_rules()
    if summary_cache is not None:
        summary_cache.prepare(project)
        project.summary_cache = summary_cache

    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.check_project(project))

    report = Report()
    for finding in sorted(raw, key=lambda f: (f.path, f.line, f.rule, f.message)):
        module = project.module_at(finding.path)
        suppression = None
        if module is not None:
            suppression = module.suppressions_for(finding.rule).get(finding.line)
        if suppression is not None:
            suppression.used = True
            report.suppressed.append(finding)
        else:
            report.findings.append(finding)

    unused: List[Finding] = []
    known = {r.id for r in all_rules()} | {UNUSED_SUPPRESSION}
    for module in project.modules:
        for s in module.suppressions:
            if s.used:
                continue
            if s.rule not in known:
                message = (
                    f"suppression names unknown rule {s.rule!r} "
                    "(see python -m flink_ml_tpu_torch.analysis --list-rules)"
                )
            else:
                message = (
                    f"unused suppression of {s.rule!r} — no finding on "
                    f"line {s.line}; delete the stale annotation"
                )
            unused.append(
                Finding(
                    path=module.path,
                    line=s.comment_line,
                    rule=UNUSED_SUPPRESSION,
                    message=message,
                )
            )
    report.findings.extend(
        sorted(unused, key=lambda f: (f.path, f.line, f.message))
    )

    if only_paths is not None:
        selected = {p.replace("\\", "/") for p in only_paths}
        report.findings = [f for f in report.findings if f.path in selected]
        report.suppressed = [f for f in report.suppressed if f.path in selected]

    if summary_cache is not None:
        graph = project._indexes.get("callgraph")
        if graph is not None:
            summary_cache.store_analyses(graph)
            summary_cache.save()
    return report
