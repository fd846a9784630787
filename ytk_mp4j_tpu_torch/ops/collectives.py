"""Functional collectives over a member list (the port of
``ytk_mp4j_tpu/ops/collectives.py:249-408``).

Members are the rows of one ``[n, ...]`` tensor on one device; each
function returns what every member holds afterwards, again as ``[n,
...]``. Where every member holds the same value the result is an
``expand`` of one tensor (a view: copy before writing into it). Rank r is
row r, which is ``flat_index`` on the reference's flat mesh axis.

Reductions: SUM, MAX and MIN fold the members in rank order (the
reference emits ``psum``/``pmax``/``pmin`` there); PROD and custom
operators take the balanced pairwise tree of
``_tree_reduce_gathered:249`` in the same order. A static table replaces
the reference's native-reduce probe (``:66-226``), which works around one
TPU compiler.
"""

from __future__ import annotations

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operator, Operators

# operators the device reduces directly, in rank order (the reference's
# lax_collective); every other operator takes the pairwise tree
NATIVE = frozenset({"SUM", "MAX", "MIN"})


def _replicate(v, n: int):
    return v.unsqueeze(0).expand((n,) + tuple(v.shape))


def _tree_reduce_gathered(x, operator: Operator):
    """Balanced pairwise tree over the members, as the reference."""
    parts = [x[i] for i in range(x.shape[0])]
    while len(parts) > 1:
        nxt = [operator.torch_fn(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def reduce_all(x, operator: Operator = Operators.SUM):
    """The element-wise reduction of members ``x`` [n, ...], once."""
    if operator.is_builtin and operator.name in NATIVE:
        acc = x[0]
        for r in range(1, x.shape[0]):
            acc = operator.torch_fn(acc, x[r])
        return acc
    return _tree_reduce_gathered(x, operator)


def allreduce(x, operator: Operator = Operators.SUM):
    """Every member gets the element-wise reduction."""
    return _replicate(reduce_all(x, operator), x.shape[0])


def reduce(x, operator: Operator = Operators.SUM, root: int = 0):
    """Reduce; only ``root``'s row is meaningful. As in the reference,
    this is the allreduce."""
    return allreduce(x, operator)


def broadcast(x, root: int = 0):
    """Every member receives ``root``'s row."""
    return _replicate(x[root], x.shape[0])


def allgather(x, tiled: bool = True):
    """Every member gets the members' rows concatenated along dim 0
    (``tiled=True``) or stacked on a new leading axis."""
    n = x.shape[0]
    g = x.reshape((n * x.shape[1],) + tuple(x.shape[2:])) if tiled else x
    return _replicate(g, n)


def gather(x, root: int = 0, tiled: bool = True):
    """Root obtains the concatenation (the allgather, as the reference)."""
    return allgather(x, tiled)


def _block(x, what: str):
    n = x.shape[0]
    if x.shape[1] % n:
        raise Mp4jError(
            f"{what} dim {x.shape[1]} not divisible by member count {n}")
    return x.shape[1] // n


def scatter(x, root: int = 0):
    """Member i receives block i of ``root``'s row."""
    b = _block(x, "scatter")
    return x[root].reshape((x.shape[0], b) + tuple(x.shape[2:]))


def reduce_scatter(x, operator: Operator = Operators.SUM):
    """Member i receives block i of the element-wise reduction."""
    b = _block(x, "reduce_scatter")
    return reduce_all(x, operator).reshape(
        (x.shape[0], b) + tuple(x.shape[2:]))


def all_to_all(x):
    """Member m's block j goes to member j: ``x`` [n_src, n_dst, ...]
    becomes [n_dst, n_src, ...], the transpose of the two member axes
    (the reference's ``lax.all_to_all(x, split_axis=0, concat_axis=0,
    tiled=False)``). A view: copy before writing into it."""
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise Mp4jError(
            f"all_to_all takes [n, n, ...] member blocks, got "
            f"{tuple(x.shape)}")
    return x.transpose(0, 1)


def flat_index(n: int, device):
    """Each member's rank, [n] int64: row r is member r (the reference's
    ``flat_index`` over the mesh axes)."""
    return torch.arange(n, device=device)


def barrier(device) -> None:
    """Members share one device: wait for its queued work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
