"""Functional collectives over a member list (the port of
``ytk_mp4j_tpu/ops/collectives.py:249-408``).

Two forms of the members, as ``device.make_mesh`` gives them:

- **packed**: the rows of one ``[n, ...]`` tensor on one device; each
  function returns what every member holds afterwards, again as ``[n,
  ...]``. Where every member holds the same value the result is an
  ``expand`` of one tensor (a view: copy before writing into it). Rank r
  is row r, which is ``flat_index`` on the reference's flat mesh axis.
- **list**: a list (or tuple) of n tensors, member r's on its own device
  (``make_mesh(n, devices=...)``); each function returns a list of n
  tensors, member r's on member r's device. The members are copied to
  member 0's device (``Tensor.to(non_blocking=True)``: PyTorch orders a
  copy between cards after the work queued on both), folded there in the
  packed form's order, and the result is copied back to each member's
  device. So the list form is bitwise the packed form. Members that share
  a device may share one result tensor (copy before writing into it).
  NCCL is not on this path: its order is not rank order, and it refuses
  a device named twice.

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


def is_list(x) -> bool:
    """Whether ``x`` holds members in the list form."""
    return isinstance(x, (list, tuple))


def _check_list(x):
    if not x:
        raise Mp4jError("a member list needs n >= 1 tensors")
    shape = tuple(x[0].shape)
    for t in x:
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise Mp4jError(
                f"list-form members must be tensors of one shape, got "
                f"{[tuple(getattr(v, 'shape', ())) for v in x]}")
    return x


def _gather_to(x, device):
    """Members ``x`` (a list) copied to ``device`` in rank order (the
    member tensors themselves where they are there already)."""
    return [t.to(device, non_blocking=True) for t in x]


def concat_on_first(x):
    """Members ``x`` (a list) concatenated along dim 0 in rank order on
    member 0's device: the list form's tiled gather."""
    return torch.cat(_gather_to(_check_list(x), x[0].device))


def spread(v, like):
    """``v`` on the device of each member of ``like`` (a list): one entry
    a member (``v`` itself for a member on ``v``'s device)."""
    return [v.to(t.device, non_blocking=True) for t in like]


def _replicate(v, n: int):
    return v.unsqueeze(0).expand((n,) + tuple(v.shape))


def _tree_reduce_gathered(x, operator: Operator):
    """Balanced pairwise tree over the members, as the reference."""
    parts = list(x) if is_list(x) else [x[i] for i in range(x.shape[0])]
    while len(parts) > 1:
        nxt = [operator.torch_fn(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def reduce_all(x, operator: Operator = Operators.SUM):
    """The element-wise reduction of members ``x`` [n, ...], once; of a
    member list, once on member 0's device."""
    if is_list(x):
        x = _gather_to(_check_list(x), x[0].device)
    if operator.is_builtin and operator.name in NATIVE:
        acc = x[0]
        for r in range(1, len(x)):
            acc = operator.torch_fn(acc, x[r])
        return acc
    return _tree_reduce_gathered(x, operator)


def allreduce(x, operator: Operator = Operators.SUM):
    """Every member gets the element-wise reduction."""
    if is_list(x):
        return spread(reduce_all(x, operator), x)
    return _replicate(reduce_all(x, operator), x.shape[0])


def reduce(x, operator: Operator = Operators.SUM, root: int = 0):
    """Reduce; only ``root``'s row is meaningful. As in the reference,
    this is the allreduce."""
    return allreduce(x, operator)


def broadcast(x, root: int = 0):
    """Every member receives ``root``'s row."""
    if is_list(x):
        return spread(_check_list(x)[root], x)
    return _replicate(x[root], x.shape[0])


def allgather(x, tiled: bool = True):
    """Every member gets the members' rows concatenated along dim 0
    (``tiled=True``) or stacked on a new leading axis."""
    if is_list(x):
        g = (concat_on_first(x) if tiled else
             torch.stack(_gather_to(_check_list(x), x[0].device)))
        return spread(g, x)
    n = x.shape[0]
    g = x.reshape((n * x.shape[1],) + tuple(x.shape[2:])) if tiled else x
    return _replicate(g, n)


def gather(x, root: int = 0, tiled: bool = True):
    """Root obtains the concatenation (the allgather, as the reference)."""
    return allgather(x, tiled)


def _block(x, what: str):
    n = len(x) if is_list(x) else x.shape[0]
    row = x[0].shape[0] if is_list(x) else x.shape[1]
    if row % n:
        raise Mp4jError(
            f"{what} dim {row} not divisible by member count {n}")
    return row // n


def _blocks_of(v, n: int, b: int):
    """One ``[L, ...]`` row as its n blocks ``[n, b, ...]``."""
    return v.reshape((n, b) + tuple(v.shape[1:]))


def scatter(x, root: int = 0):
    """Member i receives block i of ``root``'s row."""
    b = _block(x, "scatter")
    if is_list(x):
        blocks = _blocks_of(_check_list(x)[root], len(x), b)
        return [blocks[i].to(t.device, non_blocking=True)
                for i, t in enumerate(x)]
    return _blocks_of(x[root], x.shape[0], b)


def reduce_scatter(x, operator: Operator = Operators.SUM):
    """Member i receives block i of the element-wise reduction."""
    b = _block(x, "reduce_scatter")
    if is_list(x):
        blocks = _blocks_of(reduce_all(x, operator), len(x), b)
        return [blocks[i].to(t.device, non_blocking=True)
                for i, t in enumerate(x)]
    return _blocks_of(reduce_all(x, operator), x.shape[0], b)


def all_to_all(x):
    """Member m's block j goes to member j: ``x`` [n_src, n_dst, ...]
    becomes [n_dst, n_src, ...], the transpose of the two member axes
    (the reference's ``lax.all_to_all(x, split_axis=0, concat_axis=0,
    tiled=False)``). A view: copy before writing into it. A member list
    of n ``[n_dst, ...]`` tensors gives member j the ``[n_src, ...]``
    stack of every member's block j, on member j's device."""
    if is_list(x):
        n = len(_check_list(x))
        if x[0].dim() < 1 or x[0].shape[0] != n:
            raise Mp4jError(
                f"all_to_all takes n members of [n, ...] blocks, got "
                f"{n} of {tuple(x[0].shape)}")
        return [torch.stack([t[j].to(x[j].device, non_blocking=True)
                             for t in x]) for j in range(n)]
    if x.dim() < 2 or x.shape[0] != x.shape[1]:
        raise Mp4jError(
            f"all_to_all takes [n, n, ...] member blocks, got "
            f"{tuple(x.shape)}")
    return x.transpose(0, 1)


def flat_index(n: int, device):
    """Each member's rank, [n] int64: row r is member r (the reference's
    ``flat_index`` over the mesh axes). Given a list of n devices (the
    list form), member r's rank as a 0-d tensor on its device."""
    if is_list(device):
        return [torch.tensor(r, device=d) for r, d in enumerate(device)]
    return torch.arange(n, device=device)


def barrier(device) -> None:
    """Wait for the queued work of the members' device (packed), or of
    every device of a list of member devices (list form)."""
    for d in (device if is_list(device) else [device]):
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)
