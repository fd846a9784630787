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
"""

from __future__ import annotations

import torch

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operators import Operator, Operators


def _chunks(x, n: int):
    if x.shape[1] % n:
        raise Mp4jError(
            f"ring collectives need a length divisible by the member "
            f"count; got {x.shape[1]} over {n} members (pad outside)")
    return x.reshape((n, n, x.shape[1] // n) + tuple(x.shape[2:]))


def _send_right(v):
    """One ring step: member r receives member r-1's value."""
    return torch.roll(v, 1, 0)


def ring_reduce_scatter(x, operator: Operator = Operators.SUM):
    """Members ``x`` [n, L]: member r ends with chunk ``(r + 1) % n`` of
    the element-wise reduction, as ``[n, L/n]``."""
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
    n = x.shape[0]
    if n == 1:
        return x
    mine = ring_reduce_scatter(x, operator)       # chunk (r + 1) % n
    gathered = ring_allgather(mine)
    # member q's block holds chunk (q + 1) % n: roll one block into order
    return torch.roll(gathered, shifts=mine.shape[1], dims=1)
