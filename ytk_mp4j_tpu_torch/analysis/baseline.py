"""Committed suppression file (``baseline.toml``) for mp4j-lint.

A baseline entry accepts a finding permanently, with a recorded reason:

.. code-block:: toml

    [[suppression]]
    rule = "R2"
    file = "ytk_mp4j_tpu_torch/comm/process_comm.py"
    context = "ProcessCommSlave.barrier"
    reason = "barrier waits on peers indefinitely by design (fail-stop)"

Matching is by rule id, file suffix (so absolute and relative
invocations both match), and — when present — the finding's enclosing
``Class.func`` scope (``context``) and a message substring
(``contains``). Keying on scope instead of line number keeps the
baseline stable under unrelated edits.

The repo targets Python 3.10 (no ``tomllib``), so this module parses
the small TOML subset it emits: ``[[suppression]]`` tables with string
values. Anything fancier is a format error.
"""

from __future__ import annotations

import dataclasses
import re

from ytk_mp4j_tpu_torch.analysis.report import PACKAGE_ROOTS, Finding
from ytk_mp4j_tpu_torch.exceptions import Mp4jError

_TABLE_RE = re.compile(r"^\[\[suppression\]\]\s*$")
_KV_RE = re.compile(r'^(\w+)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


@dataclasses.dataclass
class Entry:
    rule: str
    file: str
    context: str = ""       # "" matches any scope
    contains: str = ""      # "" matches any message
    reason: str = ""
    line: int = 0           # the entry's own [[suppression]] line

    def match(self, f: Finding) -> bool:
        if f.rule != self.rule:
            return False
        if not (f.path == self.file or f.path.endswith("/" + self.file)):
            return False
        if self.context and f.context != self.context:
            return False
        return not self.contains or self.contains in f.message


class Baseline:
    def __init__(self, entries: list[Entry] | None = None):
        self.entries = entries or []
        self.used: set[int] = set()       # indices matched at least once

    def match(self, f: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if e.match(f):
                self.used.add(i)
                return True
        return False

    def unused(self) -> list[Entry]:
        return [e for i, e in enumerate(self.entries) if i not in self.used]


def parse(text: str) -> Baseline:
    entries: list[Entry] = []
    current: dict[str, str] | None = None
    current_line = 0

    def flush():
        nonlocal current
        if current is not None:
            if "rule" not in current or "file" not in current:
                raise Mp4jError(
                    "baseline entry missing required 'rule'/'file' keys")
            entries.append(Entry(
                rule=current["rule"], file=current["file"],
                context=current.get("context", ""),
                contains=current.get("contains", ""),
                reason=current.get("reason", ""),
                line=current_line))
            current = None

    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if _TABLE_RE.match(line):
            flush()
            current = {}
            current_line = lineno
            continue
        m = _KV_RE.match(line)
        if m and current is not None:
            current[m.group(1)] = m.group(2).replace('\\"', '"')
            continue
        raise Mp4jError(
            f"baseline.toml line {lineno}: unsupported syntax {line!r} "
            "(only [[suppression]] tables with string values)")
    flush()
    return Baseline(entries)


def load(path: str) -> Baseline:
    with open(path, encoding="utf-8") as fh:
        return parse(fh.read())


def _portable_path(path: str) -> str:
    """Entry paths must survive re-invocation from other directories:
    strip ``./`` noise and anchor absolute paths at the last package
    root (:data:`~ytk_mp4j_tpu_torch.analysis.report.PACKAGE_ROOTS`)
    when one is present (suffix matching does the rest)."""
    import posixpath

    p = posixpath.normpath(path)
    if posixpath.isabs(p):
        segs = p.split("/")
        at = [i for i, seg in enumerate(segs[:-1]) if seg in PACKAGE_ROOTS]
        if at:
            p = "/".join(segs[at[-1]:])
    return p


def _quote(s: str) -> str:
    return '"' + s.replace('"', '\\"') + '"'


def render_entries(entries: list[Entry],
                   header: str | None = None) -> str:
    """Baseline text re-serializing ``entries`` verbatim (reasons and
    ``contains`` keys preserved) — ``--prune-baseline`` rewrites the
    committed file through this so dropping stale entries never
    degrades the kept ones."""
    lines = [header if header is not None else
             "# mp4j-lint baseline — accepted findings with reasons.",
             ""]
    for e in entries:
        lines += ["[[suppression]]",
                  f"rule = {_quote(e.rule)}",
                  f"file = {_quote(e.file)}"]
        if e.context:
            lines.append(f"context = {_quote(e.context)}")
        if e.contains:
            lines.append(f"contains = {_quote(e.contains)}")
        lines += [f"reason = {_quote(e.reason)}", ""]
    return "\n".join(lines)


def render(findings, reason: str = "accepted by baseline") -> str:
    """Baseline text accepting every given finding (for --write-baseline)."""
    lines = ["# mp4j-lint baseline — accepted findings with reasons.",
             "# Regenerate with: mp4j-lint --no-baseline --write-baseline"
             " <path> (then add reasons)", ""]
    seen = set()
    for f in findings:
        key = (f.rule, _portable_path(f.path), f.context)
        if key in seen:
            continue
        seen.add(key)
        lines += [
            "[[suppression]]",
            f'rule = "{f.rule}"',
            f'file = "{_portable_path(f.path)}"',
            f'context = "{f.context}"',
            f'reason = "{reason}"',
            "",
        ]
    return "\n".join(lines)
