"""Analysis framework: file loading, suppressions, checker registry, report.

A checker declares the rules it owns (``RuleSpec``) and yields ``Finding``s
from one parsed module at a time. The runner owns everything rule-agnostic:
walking paths, parsing, attaching ``# sklint: disable=`` suppressions, and
aggregating the machine-readable report the CLI/tests/devloop consume.

Suppression contract (enforced here, not per checker):

    x = risky()  # sklint: disable=rule-a,rule-b -- one-line justification

  * applies to findings on its own line, or — when the comment stands alone
    on a line — to the next code line (for statements too long to share).
  * the justification after ``--`` (or an em dash / ``:``) is MANDATORY;
    a reasonless disable raises a ``suppression-missing-reason`` finding
    that cannot itself be suppressed.
  * unknown rule names raise ``suppression-unknown-rule`` so typos fail
    loudly instead of silently un-gating the line forever.
"""

from __future__ import annotations

import ast
import io
import re
import time
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Set, Tuple

# rule list is one whitespace-free token (kebab-case names, comma-separated);
# the justification follows after whitespace, optionally led by -- / — / :
SUPPRESS_RE = re.compile(r"#\s*sklint:\s*disable=([A-Za-z0-9_,\-]+)(?:\s+(?:--|—|:)?\s*(\S.*))?$")

#: findings the framework itself emits (checker rules register separately)
FRAMEWORK_RULES = (
    ("parse-error", "error", "file does not parse; nothing on it was checked"),
    ("suppression-missing-reason", "error", "sklint disable comment without a justification"),
    ("suppression-unknown-rule", "warning", "sklint disable names a rule that does not exist"),
    ("stale-suppression", "warning", "sklint disable whose rule no longer fires on that line (--check-suppressions)"),
)


@dataclass
class RuleSpec:
    name: str
    severity: str  # "error" | "warning"
    description: str


@dataclass
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    suppression_reason: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.location()}: [{self.severity}] {self.rule}: {self.message}{tag}"

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppression_reason": self.suppression_reason,
        }


@dataclass
class Suppression:
    line: int  # code line the suppression covers
    rules: Tuple[str, ...]
    reason: str
    comment_line: int


@dataclass
class ModuleInfo:
    """One parsed source file, as handed to every checker."""

    path: str  # as reported in findings (relative when discovered via a dir)
    source: str
    tree: ast.Module
    suppressions: List[Suppression] = field(default_factory=list)

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        for sup in self.suppressions:
            if sup.line == line and (rule in sup.rules or "all" in sup.rules):
                return sup
        return None


class Checker:
    """Base: subclasses set ``rules`` and implement ``check``."""

    rules: Tuple[RuleSpec, ...] = ()

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module: ModuleInfo, rule: str, node, message: str) -> Finding:
        spec = next(r for r in self.rules if r.name == rule)
        line = getattr(node, "lineno", 0) if not isinstance(node, int) else node
        return Finding(rule=rule, severity=spec.severity, path=module.path, line=line, message=message)


class ProjectChecker:
    """Base for whole-program passes: gets EVERY parsed module at once (the
    lock-order graph needs cross-module call edges). Findings still attach to
    one ``path:line`` each, so the per-line suppression contract applies
    unchanged."""

    rules: Tuple[RuleSpec, ...] = ()

    def check_project(self, modules: Sequence[ModuleInfo]) -> Iterator[Finding]:
        raise NotImplementedError


def all_checkers() -> List[Checker]:
    # local import: concurrency/tracer/spans import this module for the base class
    from skyplane_tpu_torch.analysis.concurrency import CONCURRENCY_CHECKERS
    from skyplane_tpu_torch.analysis.durability import DURABILITY_CHECKERS
    from skyplane_tpu_torch.analysis.framewalk import FRAMEWALK_CHECKERS
    from skyplane_tpu_torch.analysis.ipc import IPC_CHECKERS
    from skyplane_tpu_torch.analysis.lockgraph import LOCKGRAPH_CHECKERS
    from skyplane_tpu_torch.analysis.spans import SPAN_CHECKERS
    from skyplane_tpu_torch.analysis.tracer import TRACER_CHECKERS

    return [
        cls()
        for cls in (
            *CONCURRENCY_CHECKERS,
            *DURABILITY_CHECKERS,
            *TRACER_CHECKERS,
            *SPAN_CHECKERS,
            *FRAMEWALK_CHECKERS,
            *LOCKGRAPH_CHECKERS,
            *IPC_CHECKERS,
        )
    ]


def all_project_checkers() -> List[ProjectChecker]:
    from skyplane_tpu_torch.analysis.lockgraph import LOCKGRAPH_PROJECT_CHECKERS
    from skyplane_tpu_torch.analysis.resources import RESOURCE_PROJECT_CHECKERS

    return [cls() for cls in (*LOCKGRAPH_PROJECT_CHECKERS, *RESOURCE_PROJECT_CHECKERS)]


def iter_rules() -> List[RuleSpec]:
    """Every rule the pass can emit, framework rules included (docs + CLI)."""
    rules = [RuleSpec(*r) for r in FRAMEWORK_RULES]
    for checker in all_checkers():
        rules.extend(checker.rules)
    for checker in all_project_checkers():
        rules.extend(checker.rules)
    return rules


def known_rule_names() -> Set[str]:
    return {r.name for r in iter_rules()}


@dataclass
class AnalysisReport:
    findings: List[Finding] = field(default_factory=list)
    files_checked: int = 0
    wall_time_s: float = 0.0
    cache_info: dict = field(default_factory=dict)  # empty when caching is off

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.unsuppressed if f.severity == "error"]

    def ok(self) -> bool:
        return not self.unsuppressed

    def rule_counts(self) -> dict:
        """{rule: {"total", "unsuppressed"}} over EVERY known rule — zero
        entries included so the JSON keys are stable run-to-run (dashboards
        and diffs track 'rule X went 3 -> 0' without special-casing absence)."""
        counts = {name: {"total": 0, "unsuppressed": 0} for name in sorted(known_rule_names())}
        for f in self.findings:
            c = counts.setdefault(f.rule, {"total": 0, "unsuppressed": 0})
            c["total"] += 1
            if not f.suppressed:
                c["unsuppressed"] += 1
        return counts

    def as_dict(self) -> dict:
        return {
            "files_checked": self.files_checked,
            "n_findings": len(self.findings),
            "n_unsuppressed": len(self.unsuppressed),
            "ok": self.ok(),
            "wall_time_s": round(self.wall_time_s, 3),
            "rule_counts": self.rule_counts(),
            "cache": self.cache_info,
            "findings": [f.as_dict() for f in self.findings],
        }


def _parse_suppressions(source: str, known: Set[str]) -> Tuple[List[Suppression], List[Tuple[int, str]]]:
    """Extract sklint comments via the tokenizer (never fooled by strings).

    Returns (suppressions, problems) where problems are (line, kind) pairs for
    reasonless/unknown-rule disables, reported by the caller as findings.
    """
    suppressions: List[Suppression] = []
    problems: List[Tuple[int, str]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return [], []
    for i, tok in enumerate(tokens):
        if tok.type != tokenize.COMMENT:
            continue
        m = SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        # standalone comment line covers the NEXT code line; trailing covers its own
        standalone = tok.string.strip() == tok.line.strip()
        covered = tok.start[0]
        if standalone:
            for nxt in tokens[i + 1 :]:
                if nxt.type in (tokenize.NL, tokenize.NEWLINE, tokenize.COMMENT, tokenize.INDENT, tokenize.DEDENT):
                    continue
                covered = nxt.start[0]
                break
        if not reason:
            problems.append((tok.start[0], "suppression-missing-reason"))
            continue  # a reasonless disable suppresses nothing
        unknown = [r for r in rules if r not in known and r != "all"]
        for _ in unknown:
            problems.append((tok.start[0], "suppression-unknown-rule"))
        suppressions.append(Suppression(line=covered, rules=rules, reason=reason, comment_line=tok.start[0]))
    return suppressions, problems


def load_module(path: str, display_path: Optional[str] = None, known: Optional[Set[str]] = None) -> Tuple[Optional[ModuleInfo], List[Finding]]:
    display = display_path or path
    source = Path(path).read_text(encoding="utf-8", errors="replace")
    return load_module_source(source, display, known=known)


def load_module_source(source: str, display: str, known: Optional[Set[str]] = None) -> Tuple[Optional[ModuleInfo], List[Finding]]:
    known = known if known is not None else known_rule_names()
    try:
        tree = ast.parse(source, filename=display)
    except SyntaxError as e:
        return None, [Finding("parse-error", "error", display, e.lineno or 0, f"syntax error: {e.msg}")]
    suppressions, problems = _parse_suppressions(source, known)
    findings = []
    for line, kind in problems:
        severity = "error" if kind == "suppression-missing-reason" else "warning"
        msg = (
            "sklint disable without a justification — write `# sklint: disable=<rule> -- <why>`"
            if kind == "suppression-missing-reason"
            else "sklint disable names an unknown rule (typo un-gates nothing: the finding still fires)"
        )
        findings.append(Finding(kind, severity, display, line, msg))
    return ModuleInfo(path=display, source=source, tree=tree, suppressions=suppressions), findings


def _iter_py_files(paths: Sequence[str]) -> Iterator[Tuple[str, str]]:
    """Yield (fs_path, display_path) for every .py under the given paths.

    A path that does not exist (or is neither a directory nor a .py file)
    raises instead of yielding nothing: a typo'd path or wrong cwd must not
    report 'checked 0 files' with a green exit code — a vacuously clean gate
    is worse than a loud one.
    """
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                yield str(f), str(f)
        elif p.is_file() and p.suffix == ".py":
            yield str(p), str(p)
        else:
            raise FileNotFoundError(f"lint path is not a directory or .py file: {raw}")


def run_module(module: ModuleInfo, checkers: Optional[Iterable[Checker]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for checker in checkers if checkers is not None else all_checkers():
        findings.extend(checker.check(module))
    for f in findings:
        sup = module.suppression_for(f.rule, f.line)
        if sup is not None:
            f.suppressed = True
            f.suppression_reason = sup.reason
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_project(modules: Sequence[ModuleInfo], checkers: Optional[Iterable[ProjectChecker]] = None) -> List[Finding]:
    """Run the whole-program passes over a set of parsed modules, applying
    each finding's suppression from the module it is attributed to."""
    by_path = {m.path: m for m in modules}
    findings: List[Finding] = []
    for checker in checkers if checkers is not None else all_project_checkers():
        findings.extend(checker.check_project(list(modules)))
    for f in findings:
        module = by_path.get(f.path)
        if module is None:
            continue
        sup = module.suppression_for(f.rule, f.line)
        if sup is not None:
            f.suppressed = True
            f.suppression_reason = sup.reason
    return findings


def audit_suppressions(modules: Sequence[ModuleInfo], findings: Sequence[Finding]) -> List[Finding]:
    """stale-suppression: a ``# sklint: disable=<rule>`` whose rule no longer
    fires on its line. Dead suppressions rot the justification discipline —
    the comment reads as a vetted hazard when nothing is being vetted. Like
    the other suppression meta-rules, this one cannot itself be suppressed.

    Must run over the UNFILTERED findings (a ``--rule`` filter would make
    every live suppression for other rules look dead). A disable naming only
    nonexistent rules is NOT additionally stale — ``suppression-unknown-rule``
    already reports it, and "the rule no longer fires" would be misleading
    for a rule that never existed."""
    known = known_rule_names()
    out: List[Finding] = []
    for module in modules:
        for sup in module.suppressions:
            if "all" not in sup.rules and not (set(sup.rules) & known):
                continue
            live = any(
                f.path == module.path
                and f.line == sup.line
                and ("all" in sup.rules or f.rule in sup.rules)
                for f in findings
            )
            if live:
                continue
            out.append(
                Finding(
                    "stale-suppression",
                    "warning",
                    module.path,
                    sup.comment_line,
                    f"suppression for {', '.join(sup.rules)} matches no finding on line {sup.line} — "
                    "the rule no longer fires here; remove the disable (or re-anchor it)",
                )
            )
    return out


def run_source(source: str, display: str = "<string>", rules: Optional[Set[str]] = None) -> List[Finding]:
    """Analyze one source string (the fixture-test entry point). Project-wide
    passes run over the single module, so cycle fixtures work in one string."""
    module, findings = load_module_source(source, display)
    if module is not None:
        findings.extend(run_module(module))
        findings.extend(run_project([module]))
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    return findings


def run_sources(named_sources: Sequence[Tuple[str, str]], rules: Optional[Set[str]] = None) -> AnalysisReport:
    """Analyze several (display_path, source) pairs as ONE project — the
    cross-module fixture entry point for the lock-order pass."""
    report = AnalysisReport()
    modules: List[ModuleInfo] = []
    for display, source in named_sources:
        module, load_findings = load_module_source(source, display)
        report.files_checked += 1
        report.findings.extend(load_findings)
        if module is not None:
            modules.append(module)
            report.findings.extend(run_module(module))
    report.findings.extend(run_project(modules))
    if rules is not None:
        report.findings = [f for f in report.findings if f.rule in rules]
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return report


def run_paths(
    paths: Sequence[str],
    rules: Optional[Set[str]] = None,
    check_suppressions: bool = False,
    use_cache: bool = False,
    cache_path=None,
) -> AnalysisReport:
    """Analyze files/directories. With ``use_cache`` the content-hash cache
    (:mod:`skyplane_tpu_torch.analysis.cache`) makes an unchanged tree a full hit
    (no parsing) and a one-file edit re-run only that file's per-module
    checkers plus the whole-program passes. Cached findings are always
    unfiltered; the ``rules`` filter applies after, so a filtered run never
    poisons the cache."""
    t0 = time.perf_counter()
    report = AnalysisReport()
    known = known_rule_names()
    entries = [
        (display, Path(fs_path).read_text(encoding="utf-8", errors="replace"))
        for fs_path, display in _iter_py_files(paths)
    ]
    cache = None
    run_key = ""
    findings: Optional[List[Finding]] = None
    if use_cache:
        from skyplane_tpu_torch.analysis.cache import AnalysisCache, content_digest

        cache = AnalysisCache(cache_path)
        digests = [(display, content_digest(source)) for display, source in entries]
        run_key = cache.run_key(digests, check_suppressions)
        findings = cache.get_run(run_key)
    if findings is None:
        checkers = all_checkers()
        modules: List[ModuleInfo] = []
        findings = []
        for i, (display, source) in enumerate(entries):
            module, load_findings = load_module_source(source, display, known=known)
            findings.extend(load_findings)  # framework findings obey --rule like any other
            if module is None:
                continue
            modules.append(module)
            cached_mod = cache.get_module(display, digests[i][1]) if cache is not None else None
            if cached_mod is not None:
                findings.extend(cached_mod)
            else:
                mod_findings = run_module(module, checkers)
                if cache is not None:
                    cache.put_module(display, digests[i][1], mod_findings)
                findings.extend(mod_findings)
        findings.extend(run_project(modules))
        if check_suppressions:
            # over the UNFILTERED findings — see audit_suppressions
            findings.extend(audit_suppressions(modules, findings))
        if cache is not None:
            cache.put_run(run_key, findings)
    if cache is not None:
        cache.save()
        report.cache_info = cache.info()
    report.files_checked = len(entries)
    if rules is not None:
        findings = [f for f in findings if f.rule in rules]
    report.findings = findings
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    report.wall_time_s = time.perf_counter() - t0
    return report
