"""Vocabulary shared by the mp4j-lint rules: what counts as a
collective, and what counts as a rank-dependent expression, in this
codebase's idiom (slave methods ``allreduce_array``/``reduce_map``/...,
functional ops ``allreduce``/``scatter``/..., ``barrier`` /
``thread_barrier``)."""

from __future__ import annotations

import ast
from collections import Counter

from ytk_mp4j_tpu_torch.analysis.engine import call_name

# the 7 collective families of the slave contract + the barriers
_COLLECTIVE_BASES = {
    "allreduce", "reduce", "broadcast", "allgather", "gather",
    "scatter", "reduce_scatter",
}
_COLLECTIVE_SUFFIXES = ("_array", "_map", "")
_BARRIERS = {"barrier", "thread_barrier"}

# identifiers that carry a rank: the slave API names plus the local
# spellings used by the collective algorithms (vr = virtual rank in the
# binomial/halving code, _tr = thread rank)
_RANK_EXTRA = {"vr", "_tr", "tr", "src_vr", "dst_vr"}

_DEF_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
              ast.Lambda)


def is_collective_name(name: str | None) -> bool:
    if not name:
        return False
    if name in _BARRIERS:
        return True
    for suf in _COLLECTIVE_SUFFIXES:
        if suf and not name.endswith(suf):
            continue
        base = name[:len(name) - len(suf)] if suf else name
        if base in _COLLECTIVE_BASES:
            return True
    return False


def is_rankish_ident(ident: str) -> bool:
    return "rank" in ident.lower() or ident in _RANK_EXTRA


def expr_mentions_rank(expr: ast.AST) -> bool:
    """True when any identifier in the expression carries a rank."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and is_rankish_ident(node.id):
            return True
        if isinstance(node, ast.Attribute) and is_rankish_ident(node.attr):
            return True
    return False


def walk_pruned(roots, prune=_DEF_NODES):
    """Walk all nodes under ``roots`` without descending into nested
    function / class / lambda definitions: their code does not execute
    where it is written, so it doesn't belong to the enclosing
    statement's schedule."""
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, prune):
            continue
        for child in ast.iter_child_nodes(node):
            stack.append(child)


def collective_calls(body) -> Counter:
    """Multiset of collective/barrier names called by a branch arm."""
    return Counter(
        name for node in walk_pruned(body)
        if isinstance(node, ast.Call)
        and is_collective_name(name := call_name(node)))
