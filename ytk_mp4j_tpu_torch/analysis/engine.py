"""AST rule engine for mp4j-lint.

The engine parses each target file once, annotates the tree (parent
links, a ``Class.func`` scope for every node), collects inline
``# mp4j-lint: disable=Rn`` directives from the source, and runs every
registered :class:`Rule` over the tree. Rules are ``ast.NodeVisitor``
subclasses with scope tracking built in — a rule implements ``visit_*``
methods and calls :meth:`Rule.report` to emit findings.

Suppression comes in two layers:

- inline: ``# mp4j-lint: disable=R3`` (comma-separated ids, optional
  free-text reason in parentheses) on the finding's line, or on a
  comment-only line immediately above it;
- baseline: entries in ``baseline.toml`` matched by (rule, file suffix,
  scope) — see :mod:`ytk_mp4j_tpu_torch.analysis.baseline`.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import os
import re

from ytk_mp4j_tpu_torch.analysis.report import Finding, Severity

_DIRECTIVE_RE = re.compile(
    r"#\s*mp4j-lint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:\(|$)")


def attr_chain(node: ast.AST) -> list[str] | None:
    """``self._g.slots`` -> ``["self", "_g", "slots"]``; None when the
    expression is not a pure dotted name (calls, subscripts, ...)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def call_name(call: ast.Call) -> str | None:
    """Terminal name of the called object: ``a.b.c(...)`` -> ``"c"``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def receiver_chain(call: ast.Call) -> list[str] | None:
    """Dotted receiver of a method call: ``self.sock.recv(...)`` ->
    ``["self", "sock"]``; None for plain functions or computed bases."""
    if isinstance(call.func, ast.Attribute):
        return attr_chain(call.func.value)
    return None


def parse_inline_suppressions(source: str) -> dict[int, set[str]]:
    """Map of 1-based line number -> suppressed rule ids on that line.

    A directive on a comment-only line applies to the next line as well
    (so long reasons can sit above the statement they annotate)."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _DIRECTIVE_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        out.setdefault(i, set()).update(rules)
        if line.lstrip().startswith("#"):    # standalone comment line
            out.setdefault(i + 1, set()).update(rules)
    return out


@dataclasses.dataclass
class LintContext:
    """Everything a rule needs about one file."""

    path: str                       # posix-normalized display path
    tree: ast.Module
    source: str
    suppressions: dict[int, set[str]]

    def is_inline_suppressed(self, rule_id: str, line: int) -> bool:
        on = self.suppressions.get(line, ())
        return rule_id in on or "*" in on

    def in_dirs(self, *parts: str) -> bool:
        """True when the file lives under any of the given package
        directories (e.g. ``ctx.in_dirs("comm", "transport")``)."""
        segs = self.path.split("/")
        return any(p in segs for p in parts)


class Rule(ast.NodeVisitor):
    """Base class for lint rules.

    Subclasses set ``rule_id`` / ``severity`` / ``title`` /
    ``description`` and implement ``visit_*`` methods. The base visitor
    maintains ``self.scope`` (list of enclosing class/function names) —
    rules that override ``visit_FunctionDef`` / ``visit_ClassDef`` must
    call ``self.generic_visit_scoped(node)`` instead of
    ``generic_visit`` to keep it accurate.
    """

    rule_id: str = "R?"
    severity: Severity = Severity.WARNING
    title: str = ""
    description: str = ""
    # a minimal self-contained snippet the rule FIRES on, shown by
    # `mp4j-lint --explain RN` (and executed there, so the catalogue
    # stays honest); example_path places it for dir-scoped rules
    example: str = ""
    example_path: str = "ytk_mp4j_tpu_torch/comm/example.py"

    def run(self, ctx: LintContext) -> list[Finding]:
        self.ctx = ctx
        self.findings: list[Finding] = []
        self.scope: list[str] = []
        self.visit(ctx.tree)
        return self.findings

    # -- scope bookkeeping ---------------------------------------------
    def generic_visit_scoped(self, node: ast.AST) -> None:
        self.scope.append(getattr(node, "name", "<anon>"))
        try:
            self.generic_visit(node)
        finally:
            self.scope.pop()

    def visit_FunctionDef(self, node):          # noqa: N802
        self.generic_visit_scoped(node)

    def visit_AsyncFunctionDef(self, node):     # noqa: N802
        self.generic_visit_scoped(node)

    def visit_ClassDef(self, node):             # noqa: N802
        self.generic_visit_scoped(node)

    def qualname(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    # -- emission -------------------------------------------------------
    def report(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=self.rule_id,
            severity=self.severity,
            path=self.ctx.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            context=self.qualname(),
        ))


class ProgramRule:
    """Base class for WHOLE-PROGRAM rules.

    Per-file rules are blind to cross-function interleavings — a lock
    acquired here and a blocking call three frames deeper in another
    module. A ProgramRule runs ONCE over the whole indexed path set:
    ``run_program(program)`` receives a :class:`Program` exposing the
    package index (``program.index``) and the lock model
    (``program.locks``) and returns findings pinned to real
    file:line sites, so inline and baseline suppression apply
    unchanged."""

    rule_id: str = "R?"
    severity: Severity = Severity.ERROR
    title: str = ""
    description: str = ""
    example: str = ""
    example_path: str = "ytk_mp4j_tpu_torch/comm/example.py"

    def run_program(self, program: "Program") -> list[Finding]:
        raise NotImplementedError

    def finding(self, path: str, line: int, message: str,
                context: str = "<module>", col: int = 1) -> Finding:
        return Finding(rule=self.rule_id, severity=self.severity,
                       path=path, line=line, col=col, message=message,
                       context=context)


class Program:
    """The parsed path set seen whole; index, lock model, race model
    and resource model are built lazily and shared by every
    ProgramRule of one engine run — and, via :meth:`shared`, across
    SAME-PROCESS runs over identical sources (the tier-1 strict gate
    and the rule tests used to re-parse the package per run)."""

    # content-keyed cache of whole programs; tiny LRU — the tier-1
    # gate plus a handful of snippet programs is the working set
    _cache: "collections.OrderedDict[tuple, Program]" = \
        collections.OrderedDict()
    _cache_max = 4

    def __init__(self, contexts: list[LintContext]):
        self.contexts = contexts
        self._index = None
        self._locks = None
        self._races = None
        self._resources = None

    @classmethod
    def shared(cls, contexts: list[LintContext]) -> "Program":
        """The cached Program for this exact (path, source) set.
        Safe because Programs are read-only after construction and
        contexts are invalidated upstream when file content changes."""
        key = tuple((c.path, hash(c.source)) for c in contexts)
        prog = cls._cache.get(key)
        if prog is None:
            prog = cls(contexts)
            cls._cache[key] = prog
            while len(cls._cache) > cls._cache_max:
                cls._cache.popitem(last=False)
        else:
            cls._cache.move_to_end(key)
        return prog

    @property
    def index(self):
        if self._index is None:
            from ytk_mp4j_tpu_torch.analysis.callgraph import ProgramIndex
            self._index = ProgramIndex(self.contexts)
        return self._index

    @property
    def locks(self):
        if self._locks is None:
            from ytk_mp4j_tpu_torch.analysis.locks import LockModel
            self._locks = LockModel(self.index)
        return self._locks

    @property
    def races(self):
        if self._races is None:
            from ytk_mp4j_tpu_torch.analysis.races import RaceModel
            self._races = RaceModel(self.index, self.locks)
        return self._races

    @property
    def resources(self):
        if self._resources is None:
            from ytk_mp4j_tpu_torch.analysis.resources import ResourceModel
            self._resources = ResourceModel(self.index)
        return self._resources


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]          # unsuppressed
    suppressed: list[Finding]        # matched an inline or baseline entry

    @property
    def ok(self) -> bool:
        return not self.findings


class Engine:
    """Run a set of rules over files, applying suppressions.

    Two passes: per-file rules run file by file as
    always; :class:`ProgramRule` instances run once over a
    :class:`Program` built from every parsed file of the invocation —
    so ``mp4j-lint path.py`` still works (the program is that one
    file) while the tier-1 gate over the package runs the
    interprocedural rules whole-program.

    ``strict_baseline=True`` additionally reports every baseline entry
    that matched NO finding as a ``B001`` error pinned at the entry's
    own line — the baseline must stay honest as code moves. Strict
    mode only makes sense when linting the full path set the baseline
    was written against (the tier-1 gate); single-file invocations
    leave it off."""

    # path -> ((mtime_ns, size), LintContext): parsing + suppression
    # scanning is the dominant per-run cost and file content is stable
    # within a test session — contexts are reused until the file's
    # stat signature moves
    _context_cache: dict[str, tuple[tuple, "LintContext"]] = {}

    @classmethod
    def clear_caches(cls) -> None:
        """Drop the parsed-context and Program caches (benchmarks
        measuring a cold run, tests mutating files in place)."""
        cls._context_cache.clear()
        Program._cache.clear()

    def __init__(self, rules=None, baseline=None,
                 strict_baseline: bool = False,
                 baseline_path: str | None = None):
        if rules is None:
            from ytk_mp4j_tpu_torch.analysis.rules import get_rules
            rules = get_rules()
        self.rules = [r for r in rules if not isinstance(r, ProgramRule)]
        self.program_rules = [r for r in rules
                              if isinstance(r, ProgramRule)]
        self.baseline = baseline     # analysis.baseline.Baseline or None
        self.strict_baseline = strict_baseline
        self.baseline_path = baseline_path
        self.last_linted_paths: list[str] = []

    # -- file discovery -------------------------------------------------
    @staticmethod
    def collect_files(paths) -> list[str]:
        out = []
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames if d != "__pycache__")
                    out.extend(os.path.join(dirpath, f)
                               for f in sorted(filenames)
                               if f.endswith(".py"))
            else:
                out.append(p)
        return out

    # -- entry points ---------------------------------------------------
    def load_contexts(self, paths):
        """Collect and parse ``paths`` into lint contexts. Returns
        ``(contexts, error_findings)`` — unreadable/unparsable files
        become E001 findings instead of vanishing. The shared loader
        for :meth:`lint_paths`, the ``graph`` subcommand and the
        tier-1 cycle-free gate."""
        contexts: list[LintContext] = []
        errors: list[Finding] = []
        for path in self.collect_files(paths):
            ctx, errs = self._load(path)
            if ctx is None:
                errors.extend(errs)
            else:
                contexts.append(ctx)
        return contexts, errors

    def lint_paths(self, paths) -> LintResult:
        contexts, findings = self.load_contexts(paths)
        # stashed for callers needing post-run staleness (CLI prune)
        self.last_linted_paths = [ctx.path for ctx in contexts]
        suppressed: list[Finding] = []
        for ctx in contexts:
            r = self._run_file_rules(ctx)
            findings.extend(r.findings)
            suppressed.extend(r.suppressed)
        r = self._run_program_rules(contexts)
        findings.extend(r.findings)
        suppressed.extend(r.suppressed)
        findings.extend(self._stale_baseline_findings(
            self.last_linted_paths))
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return LintResult(findings, suppressed)

    def lint_file(self, path: str) -> LintResult:
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            return LintResult([Finding(
                "E001", Severity.ERROR, path.replace(os.sep, "/"),
                0, 1, f"cannot read file: {e}")], [])
        return self.lint_source(source, path)

    def lint_source(self, source: str, path: str = "<string>") -> LintResult:
        ctx, errs = self._parse(source, path)
        if ctx is None:
            return LintResult(errs, [])
        r = self._run_file_rules(ctx)
        rp = self._run_program_rules([ctx])
        return LintResult(r.findings + rp.findings,
                          r.suppressed + rp.suppressed)

    # -- internals ------------------------------------------------------
    def _load(self, path: str):
        try:
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_size)
            cached = Engine._context_cache.get(path)
            if cached is not None and cached[0] == sig:
                return cached[1], []
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            return None, [Finding(
                "E001", Severity.ERROR, path.replace(os.sep, "/"),
                0, 1, f"cannot read file: {e}")]
        ctx, errs = self._parse(source, path)
        if ctx is not None:
            Engine._context_cache[path] = (sig, ctx)
        return ctx, errs

    def _parse(self, source: str, path: str):
        display = path.replace(os.sep, "/")
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return None, [Finding(
                "E001", Severity.ERROR, display,
                e.lineno or 0, (e.offset or 0) or 1,
                f"syntax error: {e.msg}")]
        return LintContext(
            path=display,
            tree=tree,
            source=source,
            suppressions=parse_inline_suppressions(source),
        ), []

    def _apply_suppressions(self, raw, ctx_by_path) -> LintResult:
        keep: list[Finding] = []
        dropped: list[Finding] = []
        for f in raw:
            ctx = ctx_by_path.get(f.path)
            if ctx is not None \
                    and ctx.is_inline_suppressed(f.rule, f.line):
                dropped.append(f)
            elif self.baseline is not None and self.baseline.match(f):
                dropped.append(f)
            else:
                keep.append(f)
        return LintResult(keep, dropped)

    def _run_file_rules(self, ctx: LintContext) -> LintResult:
        raw: list[Finding] = []
        for rule in self.rules:
            raw.extend(rule.run(ctx))
        return self._apply_suppressions(raw, {ctx.path: ctx})

    def _run_program_rules(self, contexts) -> LintResult:
        if not self.program_rules or not contexts:
            return LintResult([], [])
        program = Program.shared(contexts)
        raw: list[Finding] = []
        for rule in self.program_rules:
            raw.extend(rule.run_program(program))
        return self._apply_suppressions(
            raw, {ctx.path: ctx for ctx in contexts})

    def stale_entries(self, linted_paths) -> list:
        """Baseline entries provably stale for THIS run: unused, AND
        their rule actually ran, AND the linted path set plausibly
        covered their file — a ``--select R18`` or single-file
        invocation cannot prove anything stale about entries it never
        looked at (code-review finding: prune/strict on a partial run
        used to condemn every live entry outside the run's scope).

        Coverage is per entry: its exact file was linted, or some
        linted path lives under the entry's top-level package segment
        (so whole-package and tmp-tree runs see deleted-file entries
        as stale, while ``mp4j-lint one_file.py`` only judges that
        file's entries). A SUBTREE run (`mp4j-lint ytk_mp4j_tpu_torch/obs`)
        still treats package-mate entries as in scope — run
        strict/prune from the package root."""
        if self.baseline is None:
            return []
        rule_ids = {r.rule_id for r in self.rules} \
            | {r.rule_id for r in self.program_rules}
        out = []
        for e in self.baseline.unused():
            if e.rule not in rule_ids:
                continue
            top = e.file.split("/")[0]
            covered = any(
                p == e.file or p.endswith("/" + e.file)
                or p.startswith(top + "/") or ("/" + top + "/") in p
                for p in linted_paths)
            if covered:
                out.append(e)
        return out

    def _stale_baseline_findings(self, linted_paths) -> list[Finding]:
        """Strict mode: an unused baseline entry is itself a finding —
        the accepted surface must shrink with the code, or a revived
        hazard at a moved site sails through on a stale excuse."""
        if not self.strict_baseline or self.baseline is None:
            return []
        path = (self.baseline_path or "baseline.toml").replace(
            os.sep, "/")
        return [Finding(
            "B001", Severity.ERROR, path, e.line, 1,
            f"stale baseline entry ({e.rule} {e.file}"
            + (f" {e.context}" if e.context else "")
            + ") no longer matches any finding — remove it (mp4j-lint "
            "--prune-baseline) or re-justify it against a live site",
            context="<baseline>")
            for e in self.stale_entries(linted_paths)]
