"""Sparse collectives over a member list (the port of
``ytk_mp4j_tpu/ops/sparse.py``).

A member's sparse contribution is a pair of dense buffers: int32 key
codes ``idx`` and values ``val`` (``[L]`` or ``[L, ...]``), unused slots
carrying :data:`SENTINEL` and the operator's identity, so padding never
changes a result. The member forms take the members' buffers in either
form of ``ops/collectives.py`` and return what every member holds
afterwards::

    concatenate the members' (idx, val)   # the reference's all_gather
    stable sort by idx                    # payload rows follow their keys
    segment-reduce runs of equal idx      # into ``capacity`` slots

- **packed**: the rows of ``[n, L]`` / ``[n, L, ...]`` tensors on one
  device; results are ``[n, ...]``;
- **list**: lists of n ``[L]`` / ``[L, ...]`` tensors, member m's on its
  own device (``make_mesh(n, devices=...)``). The members' buffers are
  copied to member 0's device and concatenated there in rank order, then
  sorted and reduced there as the packed rows are, and member m's result
  is copied to member m's device: a list of n tensors, bitwise the packed
  form's rows. Members that share a device may share one result tensor
  (copy before writing into it).

The single-stream functions (:func:`sort_by_key`, :func:`pad_to`,
:func:`segment_reduce_sorted`) are what the FM trainer's sparse steps
call on one member's slots.

The reference drops out-of-range scatter targets (``mode="drop"``); torch
raises on them. Here such a target goes to one extra dump slot past the
end, which is cut off afterwards: padding is never folded into the last
live slot. Every builtin reduction folds a segment in stream order, as
the reference's scatter does on the CPU; on a CUDA device float SUM adds
with atomics, in an order that changes from run to run, unless the
caller asks :func:`segment_reduce_sorted` for a fixed order.

The host numpy twins at the end are copies of the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch.operators import Operator, Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll

# Index sentinel for padding slots: int32 max sorts to the end and is
# never a legal key code.
SENTINEL = 2 ** 31 - 1

# keyed by the BUILTIN Operator objects, not by name: a user-defined
# Operator.custom("MAX", fn, ...) must take the generic reduction with
# its own fn
_SCATTER_REDUCE = {
    Operators.PROD: "prod",
    Operators.MAX: "amax",
    Operators.MIN: "amin",
}


def _identity_like(operator: Operator, val, shape):
    return torch.full(shape, operator.identity(val.dtype), dtype=val.dtype,
                      device=val.device)


def _rows(mask, ndim: int):
    """``mask`` [L] broadcast over the trailing dims of an ``ndim``-d
    value tensor."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def sort_by_key(idx, val):
    """Sort ``(idx, val)`` ascending by ``idx``, stably: equal keys keep
    their order, and each payload row (``val`` [L] or [L, ...]) follows
    its key."""
    si, order = torch.sort(idx, stable=True)
    return si, val[order]


def pad_to(idx, val, capacity: int, operator: Operator = Operators.SUM):
    """Pad ``(idx, val)`` to ``capacity`` slots with SENTINEL / the
    operator's identity. More entries than ``capacity`` raise
    ValueError, as in the reference."""
    L = idx.shape[0]
    if L > capacity:
        raise ValueError(f"{L} entries exceed capacity {capacity}")
    pad_i = torch.full((capacity - L,), SENTINEL, dtype=torch.int32,
                       device=idx.device)
    pad_v = _identity_like(operator, val,
                           (capacity - L,) + tuple(val.shape[1:]))
    return (torch.cat([idx.to(torch.int32), pad_i]),
            torch.cat([val, pad_v]))


def _segments(idx, capacity: int):
    """Segment id of each entry of an idx-sorted stream (runs of equal
    idx), with ids at or past ``capacity`` sent to the dump slot
    ``capacity``."""
    bounds = torch.ones(idx.shape[0], dtype=torch.int64, device=idx.device)
    if idx.shape[0] > 1:
        bounds[1:] = idx[1:] != idx[:-1]
    seg = torch.cumsum(bounds, 0) - 1
    return torch.clamp(seg, max=capacity)


def segment_reduce_sorted(idx, val, capacity: int,
                          operator: Operator = Operators.SUM,
                          in_order: bool = False):
    """Reduce runs of equal index in an idx-sorted stream into at most
    ``capacity`` unique (idx, val) slots, packed at the front in
    ascending idx order, SENTINEL / identity after them. Runs past
    ``capacity`` are dropped, as the reference's segment ops drop them;
    the run of SENTINEL slots never opens a live slot. ``in_order``: a
    CUDA float SUM adds each run in one fixed order
    (``index_put_(accumulate=True)``: the same bits on every run, where
    ``index_add_``'s atomics change from run to run)."""
    seg = _segments(idx, capacity)
    vshape = tuple(val.shape[1:])
    out_val = _identity_like(operator, val, (capacity + 1,) + vshape)
    if operator == Operators.SUM and in_order and val.device.type == "cuda":
        out_val.index_put_((seg,), val, accumulate=True)
    elif operator == Operators.SUM:
        out_val.index_add_(0, seg, val)
    elif operator in _SCATTER_REDUCE:
        out_val.scatter_reduce_(0, _rows(seg, val.dim()).expand_as(val),
                                val, reduce=_SCATTER_REDUCE[operator])
    else:
        out_val = _generic_segment_reduce(val, seg, capacity, operator)
    out_idx = torch.full((capacity + 1,), SENTINEL, dtype=torch.int32,
                         device=idx.device)
    out_idx.scatter_(0, seg, idx.to(torch.int32))
    out_idx, out_val = out_idx[:capacity], out_val[:capacity]
    # a slot that only holds SENTINEL entries carries the identity
    live = _rows(out_idx != SENTINEL, out_val.dim())
    ident = _identity_like(operator, out_val, ())
    return out_idx, torch.where(live, out_val, ident)


def _generic_segment_reduce(val, seg, capacity: int, operator: Operator):
    """Segment reduction for a user-defined operator by a segmented
    suffix scan (Hillis-Steele), calling the operator's own function:
    after round k, acc[i] covers elements [i, i + 2^k) of i's segment.
    Returns [capacity + 1, ...] with the dump slot last."""
    L = val.shape[0]
    acc = val
    stride = 1
    pos = torch.arange(L, device=val.device)
    while stride < L:
        partner = pos + stride
        ok = partner < L
        p = torch.clamp(partner, max=L - 1)
        same = _rows((seg[p] == seg) & ok, val.dim())
        acc = torch.where(same, operator.torch_fn(acc, acc[p]), acc)
        stride *= 2
    # the head of each segment carries the full reduction
    head = torch.ones(L, dtype=torch.bool, device=val.device)
    if L > 1:
        head[1:] = seg[1:] != seg[:-1]
    out = _identity_like(operator, val, (capacity + 1,) + tuple(val.shape[1:]))
    out[torch.where(head, seg, capacity)] = acc
    return out


def _replicate(x, n: int):
    return x.unsqueeze(0).expand((n,) + tuple(x.shape))


def _gathered(idx, val):
    """The members' buffers concatenated in rank order (the reference's
    tiled ``all_gather``): [n * L], [n * L, ...]; a member list's on
    member 0's device."""
    if coll.is_list(idx):
        return coll.concat_on_first(idx), coll.concat_on_first(val)
    n, L = idx.shape[:2]
    return idx.reshape(n * L), val.reshape((n * L,) + tuple(val.shape[2:]))


def _every_member(like, *xs):
    """One result ``xs`` for every member of ``like``: expanded over the
    rows of a packed form, or copied to each member's device (a list)."""
    if coll.is_list(like):
        return tuple(coll.spread(x, like) for x in xs)
    return tuple(_replicate(x, like.shape[0]) for x in xs)


def sparse_allreduce(idx, val, capacity: int,
                     operator: Operator = Operators.SUM):
    """Key-union sparse allreduce over members ``idx`` [n, L] and ``val``
    [n, L, ...] (or member lists): every member receives the union of
    keys, values reduced by ``operator``, packed ascending into
    ``capacity`` slots. Returns [n, capacity] / [n, capacity, ...], one
    union expanded over the members (a view: copy before writing into
    it), or lists of n, one a member on its device."""
    oi, ov = segment_reduce_sorted(*sort_by_key(*_gathered(idx, val)),
                                   capacity, operator)
    return _every_member(idx, oi, ov)


def block_owner(codes, size: int, n: int):
    """Owning member of each key code under the block partition of the
    key space ``[0, size)`` (``meta.owner_of``'s rule: members ``0 ..
    size % n - 1`` own ``ceil(size / n)`` codes, the rest ``floor``).
    SENTINEL and any other out-of-range code map to ``n``."""
    base, rem = divmod(size, n)
    cut = rem * (base + 1)
    codes = codes.to(torch.int64)
    small = torch.div(codes, max(base + 1, 1), rounding_mode="floor")
    big = rem + torch.div(codes - cut, max(base, 1), rounding_mode="floor")
    owner = torch.where(codes < cut, small, big)
    return torch.where((codes >= 0) & (codes < size), owner,
                       torch.full_like(owner, n))


def _keep_owned(oi, ov, members, size: int, n: int, operator: Operator):
    """Rows of the union ``(oi, ov)`` for each member rank of ``members``
    ([m, 1]): the keys it owns, packed ascending to the front, SENTINEL /
    identity after them. Returns [m, capacity] / [m, capacity, ...]."""
    mine = block_owner(oi, size, n).unsqueeze(0) == members   # [m, cap]
    keep_i = torch.where(mine, oi.unsqueeze(0),
                         torch.full_like(oi, SENTINEL).unsqueeze(0))
    keep_v = torch.where(_rows(mine, ov.dim() + 1), ov.unsqueeze(0),
                         _identity_like(operator, ov, ()))
    # repack the kept entries to the front, stably
    si, order = torch.sort(keep_i, dim=1, stable=True)
    order = _rows(order, keep_v.dim()).expand_as(keep_v)
    return si, torch.gather(keep_v, 1, order)


def sparse_reduce_scatter(idx, val, capacity: int, size: int,
                          operator: Operator = Operators.SUM):
    """The union reduced as by :func:`sparse_allreduce`, then member m
    keeps only the keys it owns under the block partition of ``[0,
    size)`` (:func:`block_owner`), packed ascending into ``capacity``
    slots. Returns [n, capacity] / [n, capacity, ...]; of member lists,
    lists, member m's share computed on member m's device."""
    oi, ov = sparse_allreduce(idx, val, capacity, operator)
    if coll.is_list(idx):
        n = len(idx)
        shares = [_keep_owned(i, v, torch.tensor([[m]], device=i.device),
                              size, n, operator)
                  for m, (i, v) in enumerate(zip(oi, ov))]
        return [i[0] for i, _ in shares], [v[0] for _, v in shares]
    n = idx.shape[0]
    members = torch.arange(n, device=idx.device).unsqueeze(1)
    return _keep_owned(oi[0], ov[0], members, size, n, operator)


def sparse_allgather(idx, val):
    """Every member's entries concatenated and sorted by key: the
    disjoint-union gather of the map family. Returns [n, n * L] / [n, n *
    L, ...] (or lists of n), live entries ascending, SENTINEL padding at
    the end; duplicate codes across members stay as adjacent entries."""
    return _every_member(idx, *sort_by_key(*_gathered(idx, val)))


def sparse_to_dense(idx, val, size: int,
                    operator: Operator = Operators.SUM):
    """Scatter (idx, val) into a dense identity-filled [size] vector (or
    [size, ...]); SENTINEL and other out-of-range slots are dropped.
    ``idx`` [L] gives one vector; member buffers ``idx`` [n, L] give one
    per member, [n, size, ...]; member lists give a list, member m's
    vector on its device."""
    if coll.is_list(idx):
        return [sparse_to_dense(i, v, size, operator)
                for i, v in zip(idx, val)]
    lead = idx.shape[:-1]
    m = int(np.prod(lead)) if lead else 1
    L = idx.shape[-1]
    vshape = tuple(val.shape[len(lead) + 1:])
    flat_i = idx.reshape(m, L).to(torch.int64)
    flat_v = val.reshape((m * L,) + vshape)
    base = torch.arange(m, device=idx.device).unsqueeze(1) * (size + 1)
    ok = (flat_i >= 0) & (flat_i < size)
    tgt = base + torch.where(ok, flat_i, torch.full_like(flat_i, size))
    out = _identity_like(operator, val, (m * (size + 1),) + vshape)
    out[tgt.reshape(-1)] = flat_v
    out = out.reshape((m, size + 1) + vshape)[:, :size]
    return out.reshape(tuple(lead) + (size,) + vshape)


# ----------------------------------------------------------------------
# Host-side numpy twins of the segment reductions (copies of the
# reference's). Bit-exactness contract: for two per-map-unique sorted
# streams concatenated LEFT column first, the stable sort keeps equal
# codes in (left, right) order and ``ufunc.reduceat`` applies the
# operator left-to-right -- exactly ``op(acc[k], src[k])``, the dict
# loop's operand order, so the two agree bit for bit on every dtype.
# ----------------------------------------------------------------------
def np_sort_columns(codes, val):
    """Host twin of :func:`sort_by_key`: jointly sort ``(codes, val)``
    ascending by code with one stable argsort (payload rows ride a
    single take)."""
    order = np.argsort(codes, kind="stable")
    return codes[order], val[order]


def np_segment_reduce_sorted(codes, val, np_fn):
    """Host twin of :func:`segment_reduce_sorted` over a code-sorted
    stream: reduce runs of equal code with ``np_fn`` (a binary numpy
    ufunc -- ``Operator.np_fn`` for the builtins), packing unique codes
    ascending. No sentinel padding: host shapes are dynamic."""
    if codes.size == 0:
        return codes, val
    head = np.empty(codes.size, bool)
    head[0] = True
    np.not_equal(codes[1:], codes[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    if starts.size == codes.size:       # all unique: nothing to reduce
        return codes, val
    # dtype pinned: reduceat otherwise promotes narrow ints to the
    # platform int (np.sum rules), which would break the bit-exactness
    # contract with the per-key scalar merge (int32+int32 -> int32)
    return codes[starts], np_fn.reduceat(val, starts, axis=0,
                                         dtype=val.dtype)


def np_merge_sorted_columns(ca, va, cb, vb, np_fn):
    """Sorted-union merge of two code-sorted column pairs (each with
    unique codes). ``(ca, va)`` is the ACCUMULATOR side -- it is
    concatenated first, so shared codes reduce as ``np_fn(acc, src)``
    (see the section comment's bit-exactness contract)."""
    if ca.size == 0:
        return cb, vb
    if cb.size == 0:
        return ca, va
    codes = np.concatenate([ca, cb])
    val = np.concatenate([va, vb])
    return np_segment_reduce_sorted(*np_sort_columns(codes, val), np_fn)
