"""The ring schedules of ``algo="ring"`` as torch ops over a member list
(the port of ``ytk_mp4j_tpu/ops/ring.py:60,82,102``).

Members are the rows of one ``[n, ...]`` tensor. A ring step, where the
reference ``lax.ppermute``s every member's value to its right neighbour,
is a roll by one along the member axis; the fold order is the
reference's, ``op(received, local)`` at every step, so results match it
bitwise wherever the operator is exact.

- :func:`ring_reduce_scatter`: n-1 steps; member r ends with chunk
  ``(r + 1) % n`` of the reduction.
- :func:`ring_allgather`: n-1 steps of forwarding; every member ends
  with ``[n * len]``, member q's shard at block q.
- :func:`ring_allreduce`: the two, then a roll of one block.

The leading length of each member must be divisible by n (pad outside).

Each function also takes the list form (``device.make_mesh(n,
devices=...)``): n member tensors ``[L, ...]``, member r's on its own
device, and returns a list the same way. A ring step is then a copy of
each member's value to its right neighbour's device; the steps and folds
are the packed form's, so the two agree bitwise.
"""

from __future__ import annotations

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operator, Operators


def _chunks(x, n: int):
    row = x[0].shape[0] if isinstance(x, (list, tuple)) else x.shape[1]
    if row % n:
        raise Mp4jError(
            f"ring collectives need a length divisible by the member "
            f"count; got {row} over {n} members (pad outside)")
    if isinstance(x, (list, tuple)):
        return [t.reshape((n, row // n) + tuple(t.shape[1:])) for t in x]
    return x.reshape((n, n, row // n) + tuple(x.shape[2:]))


def _send_right(v):
    """One ring step: member r receives member r-1's value (of a member
    list: copied to member r's device)."""
    if isinstance(v, list):
        return [v[r - 1].to(v[r].device, non_blocking=True)
                for r in range(len(v))]
    return torch.roll(v, 1, 0)


def _list_reduce_scatter(x, operator):
    n = len(x)
    ch = _chunks(x, n)
    acc = [ch[r][r] for r in range(n)]
    for s in range(n - 1):
        got = _send_right(acc)
        acc = [operator.torch_fn(got[r], ch[r][(r - s - 1) % n])
               for r in range(n)]
    return acc


def _list_allgather(x):
    n = len(x)
    out = [torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                       device=t.device) for t in x]
    cur = list(x)
    for r in range(n):
        out[r][r] = cur[r]
    for s in range(n - 1):
        cur = _send_right(cur)
        for r in range(n):
            out[r][(r - s - 1) % n] = cur[r]
    return [o.reshape((n * x[0].shape[0],) + tuple(x[0].shape[1:]))
            for o in out]


def ring_reduce_scatter(x, operator: Operator = Operators.SUM):
    """Members ``x`` [n, L]: member r ends with chunk ``(r + 1) % n`` of
    the element-wise reduction, as ``[n, L/n]``."""
    if isinstance(x, (list, tuple)):
        return _list_reduce_scatter(x, operator)
    n = x.shape[0]
    ch = _chunks(x, n)
    r = torch.arange(n, device=x.device)
    acc = ch[r, r]
    for s in range(n - 1):
        acc = operator.torch_fn(_send_right(acc), ch[r, (r - s - 1) % n])
    return acc


def ring_allgather(x):
    """Members' shards ``x`` [n, c]: every member ends with ``[n * c]``,
    member q's shard at block q."""
    if isinstance(x, (list, tuple)):
        return _list_allgather(x)
    n = x.shape[0]
    r = torch.arange(n, device=x.device)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    cur = x
    out[r, r] = cur
    for s in range(n - 1):
        cur = _send_right(cur)
        out[r, (r - s - 1) % n] = cur
    return out.reshape((n, n * x.shape[1]) + tuple(x.shape[2:]))


def ring_allreduce(x, operator: Operator = Operators.SUM):
    """Members ``x`` [n, L]: every member ends with the reduction
    (reduce-scatter + allgather, 2(n-1) steps)."""
    n = len(x) if isinstance(x, (list, tuple)) else x.shape[0]
    if n == 1:
        return list(x) if isinstance(x, (list, tuple)) else x
    mine = ring_reduce_scatter(x, operator)       # chunk (r + 1) % n
    gathered = ring_allgather(mine)
    # member q's block holds chunk (q + 1) % n: roll one block into order
    if isinstance(x, (list, tuple)):
        return [torch.roll(g, shifts=mine[0].shape[0], dims=0)
                for g in gathered]
    return torch.roll(gathered, shifts=mine.shape[1], dims=1)
