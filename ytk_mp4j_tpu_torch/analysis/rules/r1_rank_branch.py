"""R1 — collective call under a rank-dependent branch.

The classic MPI deadlock shape: a branch conditioned on the caller's
rank (``rank`` / ``thread_rank`` / ``proc_rank`` / the algorithms'
``vr`` / ``_tr``) where the two arms do not issue the same collective
schedule. Ranks taking different arms then disagree about which
collective comes next and the job hangs with no error.

Balanced branches (both arms issue the same multiset of collectives)
are fine — e.g. ``if rank == 0: broadcast(...) else: broadcast(...)``
with different operands. Point-to-point sends/receives inside rank
branches are NOT flagged: that is the normal shape of the binomial /
halving algorithms themselves.

Known-good idioms that structurally match (a leader thread joining the
process barrier between two thread barriers) carry inline
``# mp4j-lint: disable=R1`` suppressions documenting why they are safe.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule
from ytk_mp4j_tpu_torch.analysis.report import Severity
from ytk_mp4j_tpu_torch.analysis.rules.common import (
    collective_calls, expr_mentions_rank)


class R1RankConditionalCollective(Rule):
    rule_id = "R1"
    severity = Severity.ERROR
    title = "rank-conditional collective"
    description = ("collective/barrier call inside a branch conditioned "
                   "on rank, without a matching call on the other arm")
    example = """\
def step(comm, grads):
    comm.allreduce_array(grads)
    if comm.rank == 0:
        comm.barrier()          # ranks != 0 never arrive
"""

    def visit_If(self, node: ast.If):           # noqa: N802
        if expr_mentions_rank(node.test):
            body_calls = collective_calls(node.body)
            orelse_calls = collective_calls(node.orelse)
            if body_calls != orelse_calls:
                only = body_calls - orelse_calls or orelse_calls - body_calls
                names = ", ".join(sorted(only))
                self.report(node, (
                    f"collective schedule differs across a rank-dependent "
                    f"branch ({names} on one arm only): ranks taking "
                    f"different arms will deadlock"))
        self.generic_visit(node)
