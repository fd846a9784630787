"""R15 — roster-derived topology cached in a long-lived attribute.

Elastic membership made the roster MUTABLE mid-job: a
replacement swaps a dead rank's roster entry, and a shrink renumbers
every survivor — ``self._rank``, ``self._n``, the host groups and the
leader sets all change at an ``abort_go``. The one safe pattern is the
roster-versioned accessor: ``ProcessCommSlave._set_roster`` derives
every topology quantity in one place, and everything else READS those
attributes at use time. Code that derives-and-caches its own copy
(``self._fanout = self._n - 1`` in ``__init__``, a member list squirreled
away at construction) keeps answering with the OLD topology after a
membership change — the silent-wrong-schedule class that deadlocks or
mispairs exchanges instead of failing loudly.

Heuristic: inside a class in ``comm/``, an assignment whose TARGET is a
``self.…`` attribute and whose VALUE reads a topology source through
``self`` — ``self._n`` / ``self._rank`` / ``self._roster`` /
``self.slave_num`` / ``self.rank`` / ``self._host_groups`` /
``self._members`` / ``self._leader`` / ``self._leaders`` — or calls
``_derive_host_groups``. Local variables (read-at-use-time) and plain
reads are never flagged; only the caching assignment is. Sanctioned
sites — the accessor itself, the identity mirrors it drives, and the
fixed-roster backends (thread/device groups cannot shrink or be
replaced mid-job) — are accepted in baseline.toml or carry inline
suppressions.
"""

from __future__ import annotations

import ast

from ytk_mp4j_tpu_torch.analysis.engine import Rule, attr_chain, call_name
from ytk_mp4j_tpu_torch.analysis.report import Severity

# the roster-derived quantities _set_roster owns (reading one of these
# into a long-lived attribute is caching topology)
_SOURCES = frozenset({
    "_n", "_rank", "_roster", "slave_num", "rank",
    "_host_groups", "_members", "_leader", "_leaders",
})

# deriving helpers whose result IS topology
_DERIVERS = frozenset({"_derive_host_groups"})


def _reads_topology(expr: ast.AST) -> str | None:
    """The first topology source ``expr`` reads through ``self`` (or a
    deriving call), else None. F-string subtrees are pruned: a rank
    interpolated into a thread NAME or log label is cosmetic identity,
    not a schedule-bearing cache (the R11 operand-pruning precedent)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.JoinedStr):
            continue            # cosmetic: f"...{self._rank}..."
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            if (chain and len(chain) == 2 and chain[0] == "self"
                    and chain[1] in _SOURCES):
                return chain[1]
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if name in _DERIVERS:
                return name + "()"
        stack.extend(ast.iter_child_nodes(node))
    return None


def _self_attr_target(target: ast.AST) -> str | None:
    """Dotted name of a ``self.…`` assignment target, else None."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for el in target.elts:
            got = _self_attr_target(el)
            if got is not None:
                return got
        return None
    if not isinstance(target, ast.Attribute):
        return None
    chain = attr_chain(target)
    if chain and chain[0] == "self" and len(chain) >= 2:
        return ".".join(chain)
    return None


class R15TopologyCache(Rule):
    rule_id = "R15"
    severity = Severity.ERROR
    title = "roster-derived topology cached in a long-lived attribute"
    description = ("an attribute assignment derives its value from "
                   "rank/slave_num/roster topology; elastic membership "
                   "(replace/shrink) mutates those mid-job, so the "
                   "cache silently answers with the OLD topology — "
                   "read through the roster-versioned accessor "
                   "(_set_roster's attributes) at use time instead")
    example = """\
class Slave:
    def __init__(self, roster):
        self._n = len(roster)
        self._right = (self._rank + 1) % self._n    # stale after shrink
"""

    def _in_scope(self) -> bool:
        # class bodies only: a module-level constant cannot cache a
        # live object's topology, and free functions receive theirs
        # as arguments (read-at-call-time, which is the point)
        return self.ctx.in_dirs("comm") and len(self.scope) >= 2

    def visit_Assign(self, node):               # noqa: N802
        self._check(node, node.targets, node.value)

    def visit_AnnAssign(self, node):            # noqa: N802
        if node.value is not None:
            self._check(node, [node.target], node.value)

    def visit_AugAssign(self, node):            # noqa: N802
        self._check(node, [node.target], node.value)

    def _check(self, node, targets, value) -> None:
        if not self._in_scope():
            return
        src = _reads_topology(value)
        if src is None:
            return
        for tgt in targets:
            name = _self_attr_target(tgt)
            if name is None:
                continue
            if name.split(".", 1)[1] in _SOURCES:
                # writing a source itself is (re)derivation, not
                # caching — only the sanctioned sites do it, and they
                # are baselined as such; skipping here keeps the rule
                # about CONSUMERS
                continue
            self.report(node, (
                f"'{name}' caches topology derived from "
                f"'{src}': a replace/shrink membership change "
                "mutates rank/slave_num/roster mid-job and this "
                "attribute keeps the old answer — read the "
                "roster-versioned attributes (_set_roster) at use "
                "time instead"))
            return
