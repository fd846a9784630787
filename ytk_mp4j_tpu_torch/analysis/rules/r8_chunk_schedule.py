"""R8 — chunk schedule derived from rank-local state.

The pipelined collective engine splits per-step segments into
``MP4J_CHUNK_BYTES`` chunks. The chunk SCHEDULE (how many chunks, what
sizes) must be a pure function of job-wide call parameters — segment
size, dtype, env thresholds — exactly like the raw/framed wire decision
(R4's contract): two peers of one exchange derive the schedule
independently, and a rank-local input (``rank``, ``vr``, a thread rank)
would make them disagree about how many transfers to expect. Unlike a
mismatched operand, a mismatched chunk count doesn't corrupt data — it
deadlocks one side waiting for a chunk the other never sends.

Heuristic: a ``for``/``while`` loop in ``comm/`` / ``transport/`` whose
header (the iterable / the condition) mentions BOTH a chunk-ish
identifier (``*chunk*`` — the engine's naming convention:
``chunk_ranges``, ``_chunk_bytes``, ``n_chunks``, ...) and a rank-ish
identifier (``rank`` / ``vr`` / ``_tr`` ..., the R1 vocabulary). Using
a rank to pick WHICH segment to move is the normal shape of the
ring/halving algorithms and is not flagged — only rank-dependence
inside the chunk-loop header itself, where it sizes the schedule.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule
from ytk_mp4j_tpu_torch.analysis.report import Severity
from ytk_mp4j_tpu_torch.analysis.rules.common import expr_mentions_rank

_SCHEDULE_DIRS = ("comm", "transport")


def _is_chunkish(ident: str) -> bool:
    return "chunk" in ident.lower()


def _mentions_chunk(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and _is_chunkish(node.id):
            return True
        if isinstance(node, ast.Attribute) and _is_chunkish(node.attr):
            return True
    return False


class R8RankLocalChunkSchedule(Rule):
    rule_id = "R8"
    severity = Severity.ERROR
    title = "rank-local chunk schedule"
    description = ("chunk-loop trip count depends on rank-local state; "
                   "peers would disagree on the number of transfers "
                   "and deadlock")
    example = """\
def exchange(self, arr):
    for lo, hi in chunk_ranges(arr.size - self.rank, 8, CHUNK):
        self._exchange_raw(1, 1, arr[lo:hi], None)
"""

    def _check_header(self, node: ast.AST, header: ast.AST) -> None:
        if not self.ctx.in_dirs(*_SCHEDULE_DIRS):
            return
        if _mentions_chunk(header) and expr_mentions_rank(header):
            self.report(node, (
                "chunk schedule derived from rank-local state: the "
                "trip count must be a pure function of job-wide call "
                "parameters (segment size, dtype, MP4J_CHUNK_BYTES) "
                "or peers deadlock expecting different chunk counts"))

    def visit_For(self, node: ast.For):         # noqa: N802
        self._check_header(node, node.iter)
        self.generic_visit(node)

    def visit_While(self, node: ast.While):     # noqa: N802
        self._check_header(node, node.test)
        self.generic_visit(node)
