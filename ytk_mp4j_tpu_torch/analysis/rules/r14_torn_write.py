"""R14 — telemetry-artifact write without the torn-write discipline.

Postmortem bundles, audit dumps, trace exports and sink manifests are
read by OTHER processes, possibly while the writer is dying: a plain
``open(path, "w")`` + ``json.dump`` torn by a crash leaves a
syntactically truncated file at the REAL path, and a reader (the
``mp4j-scope`` report, the bench-diff gate) either crashes on it or —
worse — silently trusts a half-written document. The discipline is
tmp-file + ``os.replace``: the visible path only ever holds a
complete artifact (see ``obs.postmortem._dump``). Append-only streams
are the one exception — the durable sink's crc-framed segments
(``obs/sink.py``) tolerate a torn tail BY DESIGN and must append in
place; such sites carry a baseline entry arguing exactly that.

Heuristic: in ``obs/`` (where every telemetry/postmortem/sink writer
lives), an ``open(..., mode)`` call whose mode string writes (``w``/
``a``/``x``/``+``) fires unless the ENCLOSING function also calls
``os.replace`` (the tmp+rename discipline — the lint is scope-local,
like R13's pin tracking). Reads (``r``/``rb``/default mode) never
fire.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, attr_chain, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

_WRITE_CHARS = set("wax+")


class R14TornWrite(Rule):
    rule_id = "R14"
    severity = Severity.ERROR
    title = "telemetry artifact written without tmp+os.replace"
    description = ("a write-mode open() in obs/ whose scope never "
                   "calls os.replace can tear mid-crash and leave a "
                   "truncated artifact at the real path; write to a "
                   ".tmp sibling and os.replace it (append-only "
                   "crc-framed streams are baselined exceptions)")
    example = """\
import json

def dump(path, obj):
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh)      # a crash mid-write leaves a torn file
"""
    example_path = "ytk_mp4j_tpu_torch/obs/example.py"

    _MSG = ("open(..., {mode!r}) without os.replace in scope: a crash "
            "mid-write leaves a torn file at the visible path that "
            "readers may trust as complete; write a tmp sibling and "
            "os.replace it (or baseline the site if the format is "
            "append-only and torn-tail tolerant)")

    def run(self, ctx):
        self._opens: list[tuple[str, str, ast.Call]] = []
        self._replacing: set[str] = set()
        return super().run(ctx)

    def visit_Module(self, node):               # noqa: N802
        if not self.ctx.in_dirs("obs"):
            return
        self.generic_visit(node)
        for mode, qual, call in self._opens:
            if qual in self._replacing:
                continue
            self.findings.append(self._finding(call, mode, qual))

    def _finding(self, call, mode, qual):
        from ytk_mp4j_tpu_torch.analysis.report import Finding
        return Finding(
            rule=self.rule_id, severity=self.severity,
            path=self.ctx.path,
            line=getattr(call, "lineno", 0),
            col=getattr(call, "col_offset", 0) + 1,
            message=self._MSG.format(mode=mode),
            context=qual)

    def visit_Call(self, node):                 # noqa: N802
        qual = self.qualname()
        name = call_name(node)
        if name == "replace":
            chain = attr_chain(node.func)
            if chain and chain[0] == "os":
                self._replacing.add(qual)
        if isinstance(node.func, ast.Name) and node.func.id == "open":
            mode = self._mode(node)
            if mode is not None and _WRITE_CHARS & set(mode):
                self._opens.append((mode, qual, node))
        self.generic_visit(node)

    @staticmethod
    def _mode(node: ast.Call) -> str | None:
        """The literal mode string of an open() call (positional or
        keyword); None for default/read-only or a computed mode (a
        computed mode is someone else's contract)."""
        mode = None
        if len(node.args) >= 2:
            mode = node.args[1]
        else:
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
        if mode is None:
            return None
        if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
            return mode.value
        return None
