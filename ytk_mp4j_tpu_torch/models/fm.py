"""Data-parallel factorization machines, FM and field-aware FFM (the port
of ``ytk_mp4j_tpu/models/fm.py``), over a mesh of members on one device or
over the processes of a ``torch.distributed`` job.

Instances are padded to ``max_nnz`` slots (feature id / field id / value
/ mask; a padded slot has value 0). Member m trains on rows ``[m * per,
(m + 1) * per)``; a batch is a tuple of ``[n_local, per, ...]`` tensors
(this process's members; every member on a one-process mesh). The
embedding-gradient exchange takes one of three forms:

- **dense** (default): the full table's gradient, one autograd pass over
  the local members' rows (the reference's per-member gradients and
  ``psum``); over processes each rank's table gradient is summed by one
  backend all-reduce (:func:`_sum_table_grads`);
- **sparse** (``sparse_grads=True``): autograd with respect to the
  gathered slot rows E, never through the table; each member's (row,
  gradient row) slots, merged locally by sort + segment reduction when
  ``sparse_capacity`` is below the member's slot count, are concatenated
  in rank order (the reference's ``all_gather``; over processes
  :func:`_gather_updates`) and added into the table with one
  ``index_add_``;
- **sharded table** (``table_sharding="sharded"``): member m owns table
  rows ``[m * B, (m + 1) * B)``. Forward: on one process every owner sees
  every member's row ids, answers with the rows it holds, and
  ``ops.collectives.all_to_all`` delivers them ([n, n, S, k] blocks);
  over processes each process holds its own members' blocks, and each
  row id travels only to the process that owns it and its row back
  (:func:`_fetch_rows_across`, an all-to-all with split sizes).
  Backward: gradient rows go to their owners the same way, and each
  owner merges the rows it owns of what it received by sort + segment
  reduction into ``C = min(n * S, B)`` slots before adding them into its
  rows.

Scores: FM ``w0 + sum_i w_i x_i + sum_{a<b} <v_a, v_b> x_a x_b`` by the
sum-of-squares identity; FFM ``sum_{a<b} <v_{a, field_b}, v_{b,
field_a}> x_a x_b`` over the K^2 slot pairs.

One copy of the replicated parameters serves every local member, so one
autograd pass over their rows already gives the sum the reference's
explicit ``psum`` computes; nothing is folded n times. Over processes
each rank's weighted loss sum, sample-weight sum and the gradients of
``w0`` and ``w`` are gathered and folded in rank order
(``_base.job_sum``), and every step divides by the job's weight sum.
Every rank holds the replicated parameters bit for bit: the folds and
the all-reduce hand every rank the same sums, the gathered slots are the
same bytes everywhere, and on a CUDA device the replicated sparse path
adds them with ``index_put_(accumulate=True)`` (a sort of the rows, then
each row's adds in one fixed order) where ``index_add_`` would add with
atomics in an order that changes from run to run.
On the CPU a slot's gradient is its instance's alone, so the table rows
of the sparse and sharded paths get the same gradient rows and the same
adds in the same order as on a one-process mesh of the same members;
the first step's table is bitwise the one-process table, but the folded
sums of ``w0``, ``w`` and the loss round apart from one autograd pass, so
over several steps the runs agree to rounding (rtol 1e-5), not bitwise.

Over a list mesh (``make_mesh(n, devices=...)``, member m on
``devices[m]``) a batch is a tuple of member lists and each member
computes its gradients over its own rows on its device; the members'
loss, weight sum and gradients of ``w0`` and ``w`` are folded in rank
order on member 0's device (``_base.fold_members``, the reference's
``psum``) and handed back. Each member holds a replica of its own of the
replicated parameters (a tensor of its own even where the devices
repeat, since the sparse steps write in place) or, with the sharded
table, its block ``[B, k]`` on its device:

- **dense** (:func:`train_step_dense_members`): the members' table
  gradients folded in rank order (``ops.collectives.allreduce``);
- **sparse** (:func:`train_step_sparse_members`): each member's slots,
  merged on its device when ``capacity < S``, concatenated in rank order
  onto every member (the list ``allgather``) and added into every
  replica, the merges and the adds in one fixed order
  (``index_put_(accumulate=True)`` on a card), so every replica holds
  the same bits and two runs the same bits;
- **sharded** (:func:`train_step_sparse_sharded_members`): the packed
  form's owner-routed fetch and gradient return, its dense ``[n_own,
  n_req, S, k]`` blocks split by owner, through the list ``allgather``
  of the row ids and the list ``all_to_all``; each owner's merge in one
  fixed order.

The fold is the process path's (one partial a member, in rank order), so
on the CPU a list of n members equals n processes of one member bit for
bit; against the packed mesh, whose one autograd pass sums every
member's rows, the losses and parameters agree to rounding (rtol 1e-5).
``fit`` and ``fit_stream`` return member 0's replica ``(w0, w, V)`` or,
with the sharded table, ``(w0, w, blocks)``, ``blocks`` the list of the
members' blocks on their devices (every member's parameters stay in
``replicas_``); the eval set, ``predict``, ``full_table`` and
``save_params`` work on member 0's device, and every entry point takes
either that form or a whole table, of either package.

Every method of a trainer over processes is a collective where the
sharded table is concerned (``fit``, ``fit_stream``, ``predict``,
``full_table``, ``save_params``): every rank calls it together, with the
same global arrays. ``fit(comm=)`` sums each step's training loss over
the comm's ranks into ``sync_loss_history_`` (their mean), through
``_base.StepStatsExchanger``.

Intended divergences from the reference:

- the sparse steps update the embedding table in place (the trainer
  copies the parameters it is given once, at the start of ``fit`` and
  ``fit_stream``); the reference's step is functional;
- ``predict`` returns a tensor on the device; on a mesh over processes
  with the sharded table, ``fit`` returns this process's blocks of the
  table (``full_table`` gathers them) and every other entry point takes
  either those blocks or a whole table;
- on a one-process mesh on a CUDA device the table updates add with
  atomics, in an order that changes from run to run, so two runs of the
  same steps agree to float rounding (rtol 1e-5 on the losses, as the
  reference's dry run holds its stream to its full batch), not bitwise;
  on a list mesh every merge and every add runs in one fixed order, so
  the replicas hold the same bits and two runs are bitwise on every
  path; on the CPU every add runs in stream order and ``fit_stream``
  over one full-batch chunk per epoch equals ``fit`` bitwise;
- :class:`FMServable` (:func:`servable`, the serve plane's pull-mode
  adapter, scoring on the host in numpy as the reference does) takes the
  port's tensors on any device, keeping detached float32 host copies, or
  numpy arrays, where the reference fetches with ``jax.device_get``; a
  table sharded over processes goes through :meth:`FMTrainer.full_table`
  first (a process's blocks alone are refused).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ytk_mp4j_tpu_torch.comm.distributed import (all_gather_rows,
                                                 all_reduce_,
                                                 all_to_all_rows,
                                                 exchange_counts)
from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models._base import (DataParallelTrainer,
                                             EarlyStopper,
                                             StepStatsExchanger, as_numpy,
                                             as_tensor, fold_members,
                                             job_sum, per_example_loss)
from ytk_mp4j_tpu_torch.operators import Operators
from ytk_mp4j_tpu_torch.ops import collectives as coll
from ytk_mp4j_tpu_torch.ops import sparse as sparse_ops
from ytk_mp4j_tpu_torch.ops.collectives import all_to_all, flat_index

MODELS = ("fm", "ffm")
LOSSES = ("logistic", "squared")


@dataclass(frozen=True)
class FMConfig:
    n_features: int                 # vocabulary size |V|
    n_fields: int = 1               # >1 + model="ffm" => field-aware
    k: int = 8                      # latent dimension
    max_nnz: int = 16               # slots per instance
    model: str = "fm"
    loss: str = "logistic"
    learning_rate: float = 0.1
    l2: float = 0.0                 # on embeddings + linear weights
    init_scale: float = 0.01

    def __post_init__(self):
        if self.model not in MODELS:
            raise Mp4jError(f"model must be one of {MODELS}")
        if self.loss not in LOSSES:
            raise Mp4jError(f"loss must be one of {LOSSES}")
        if self.model == "ffm" and self.n_fields < 2:
            raise Mp4jError("ffm needs n_fields >= 2")


def n_table_rows(cfg: FMConfig) -> int:
    """Embedding-table rows: |V| for FM, |V| * n_fields for FFM."""
    if cfg.model == "fm":
        return cfg.n_features
    return cfg.n_features * cfg.n_fields


def _gather_slots(V, rows):
    """The one embedding gather: per-slot rows of the table. ``rows``
    come from :func:`_slot_rows`; the result appends the latent dim."""
    return V[rows]


def _score_from_slots(w0, w, E, feats, xv, cfg: FMConfig):
    """Model score given the gathered embedding rows ``E`` (the sparse
    steps differentiate with respect to E directly). ``feats`` / ``xv``
    are [..., K]; ``E`` is [..., K, k] (fm) or [..., K, K, k] (ffm)."""
    linear = torch.sum(w[feats] * xv, dim=-1)
    if cfg.model == "fm":
        # 0.5 * ((sum_a v_a x_a)^2 - sum_a (v_a x_a)^2), summed over k
        Ex = E * xv.unsqueeze(-1)                      # [..., K, k]
        s = torch.sum(Ex, dim=-2)                      # [..., k]
        inter = 0.5 * torch.sum(s * s - torch.sum(Ex * Ex, dim=-2), dim=-1)
    else:
        # FFM: E[a, b] = v_{feat_a, field_b}; z += <E[a,b], E[b,a]> x_a x_b
        pair = torch.sum(E * E.transpose(-3, -2), dim=-1)   # [..., K, K]
        pair = pair * (xv.unsqueeze(-1) * xv.unsqueeze(-2))
        K = feats.shape[-1]
        upper = torch.triu(torch.ones((K, K), dtype=pair.dtype,
                                      device=pair.device), 1)
        inter = torch.sum(pair * upper, dim=(-2, -1))
    return w0 + linear + inter


def _slot_rows(feats, fields, cfg: FMConfig):
    """Embedding-table row touched by each gradient slot: ``feat`` per
    slot for FM ([..., K]); ``feat * n_fields + field_b`` per slot pair
    for FFM ([..., K, K])."""
    if cfg.model == "fm":
        return feats
    return feats.unsqueeze(-1) * cfg.n_fields + fields.unsqueeze(-2)


def _score(params, feats, fields, vals, mask, cfg: FMConfig):
    """Model score of a batch of padded sparse instances."""
    w0, w, V = params
    xv = vals * mask                                   # zero padded slots
    E = _gather_slots(V, _slot_rows(feats, fields, cfg))
    return _score_from_slots(w0, w, E, feats, xv, cfg)


def _grad_sums(leaves, score_fn, y, sw, cfg: FMConfig):
    """The weighted loss SUM over the rows, the weight sum and the loss
    sum's gradients with respect to ``leaves`` (one autograd pass):
    (sum_loss, sw_sum, grads)."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        sum_loss = torch.sum(
            per_example_loss(score_fn(*leaves), y, cfg.loss) * sw)
        grads = list(torch.autograd.grad(sum_loss, leaves))
    return sum_loss.detach(), torch.sum(sw), grads


def _fold_member_sums(sums):
    """The members' ``(sum_loss, sw_sum, grads)`` (one a member of a
    list, on its device): the loss, weight sums and the gradients of w0
    and w folded in rank order (``_base.fold_members``). Returns, a
    member, (loss, g0, gw, denom) on its device."""
    out = []
    for sum_loss, sw_sum, g0, gw in fold_members(
            [(s, w, g[0], g[1]) for s, w, g in sums]):
        denom = torch.clamp(sw_sum, min=1.0)
        out.append((sum_loss / denom, g0, gw, denom))
    return out


def _loss_and_grads(leaves, score_fn, y, sw, cfg: FMConfig, group=None):
    """The weighted-mean loss over the local members' rows and the
    gradients of the weighted loss SUM with respect to ``leaves`` ``(w0,
    w, X)`` (one autograd pass: one copy of the parameters serves every
    member, so this is the sum over members). With a process ``group``
    the loss sum, the weight sum and the gradients of w0 and w are the
    job's (:func:`_base.job_sum`); X's stays the rank's. Returns (loss,
    grads, denom)."""
    sum_loss, sw_sum, grads = _grad_sums(leaves, score_fn, y, sw, cfg)
    if group is not None:
        g0, gw = grads[0], grads[1]
        flat = job_sum(torch.cat([sum_loss.reshape(1), sw_sum.reshape(1),
                                  g0.reshape(1), gw.reshape(-1)]), group)
        sum_loss, sw_sum = flat[0], flat[1]
        grads[0], grads[1] = flat[2].reshape(g0.shape), flat[3:]
    denom = torch.clamp(sw_sum, min=1.0)
    return sum_loss / denom, grads, denom


def _update_linear(w0, w, g0, gw, denom, cfg: FMConfig):
    lr = cfg.learning_rate
    return w0 - lr * (g0 / denom), w - lr * (gw / denom + cfg.l2 * w)


def _index_add(V, rows, upd, in_order: bool = False):
    """``V[rows] += upd``. Duplicate rows add in stream order on the CPU;
    on CUDA ``index_add_`` adds them with atomics, in an order that
    changes from run to run, so where every rank must hold the same bits
    (``in_order``) ``index_put_(accumulate=True)`` takes its place: a
    sort of the rows, then each row's adds in one fixed order (the same
    bits on every run; they round apart from the CPU's stream order)."""
    if in_order and V.device.type == "cuda":
        V.index_put_((rows.long(),), upd, accumulate=True)
    else:
        V.index_add_(0, rows.long(), upd)


def _add_rows(V, rows, upd, in_order: bool = False):
    """``V[rows] += upd`` for the live rows (SENTINEL rows are dropped);
    see :func:`_index_add`."""
    keep = rows != sparse_ops.SENTINEL
    _index_add(V, rows[keep], upd[keep], in_order)


def _sum_table_grads(gV, group):
    """The dense path's table gradient summed over the ranks of
    ``group``, in place: one backend all-reduce, which hands every rank
    the same sums. (The rank-order fold gathers P copies: 2.5 GB a rank
    for the 624 MB table of Criteo width over 4 ranks.)"""
    return all_reduce_(gV, Operators.SUM, group)


def _gather_updates(ids, vals, group):
    """Every rank's (row, gradient row) slots, concatenated in rank order
    on every rank (the reference's ``all_gather``): ``([P * L], [P * L,
    k])``."""
    return (all_gather_rows(ids, group).reshape(-1),
            all_gather_rows(vals, group).reshape(-1, vals.shape[-1]))


def train_step_dense(params, batch, cfg: FMConfig, group=None):
    """One step over member batches ``[n_local, per, ...]`` (this
    process's members of the job of ``group``); the embedding gradient is
    the dense table's. Returns (params, loss)."""
    feats, fields, vals, mask, y, sw = batch
    loss, (g0, gw, gV), denom = _loss_and_grads(
        params, lambda *p: _score(p, feats, fields, vals, mask, cfg),
        y, sw, cfg, group)
    if group is not None:
        gV = _sum_table_grads(gV, group)
    w0, w, V = params
    w0, w = _update_linear(w0, w, g0, gw, denom, cfg)
    V = V - cfg.learning_rate * (gV / denom + cfg.l2 * V)
    return (w0, w, V), loss


def _slot_score(batch, cfg: FMConfig):
    """The score of ``batch``'s instances as a function of ``(w0, w,
    E)``, ``E`` the gathered slot rows (what the sparse steps
    differentiate)."""
    feats, _, vals, mask = batch[:4]
    xv = vals * mask
    return lambda a, b, c: _score_from_slots(a, b, c, feats, xv, cfg)


def _sparse_grads(params, batch, cfg: FMConfig, E, group=None):
    """Loss and gradients of the sparse steps, differentiated with
    respect to the gathered slot rows ``E``: (loss, g0, gw, gE, denom)."""
    loss, (g0, gw, gE), denom = _loss_and_grads(
        (params[0], params[1], E), _slot_score(batch, cfg), batch[4],
        batch[5], cfg, group)
    return loss, g0, gw, gE, denom


def train_step_sparse(params, batch, cfg: FMConfig, capacity: int,
                      group=None):
    """One step whose embedding gradients ride the sparse path: each
    member's (row, gradient row) slots -- merged by sort + segment
    reduction into ``capacity`` slots when that is below the member's
    slot count S -- are concatenated in rank order (over processes:
    gathered from every rank) and added into the table, which merges
    duplicate rows. Updates the table in place; returns (params, loss)."""
    feats, fields = batch[0], batch[1]
    V = params[2]
    rows = _slot_rows(feats, fields, cfg)      # [n_local, per, K(, K)]
    n = rows.shape[0]
    S = rows[0].numel()
    k = V.shape[1]
    loss, g0, gw, gE, denom = _sparse_grads(params, batch, cfg,
                                            _gather_slots(V, rows), group)
    flat_rows = rows.reshape(n, S)
    flat_g = gE.reshape(n, S, k)
    w0, w = _update_linear(params[0], params[1], g0, gw, denom, cfg)
    lr = cfg.learning_rate
    if cfg.l2:
        V.mul_(1.0 - lr * cfg.l2)       # decay all rows, like the dense
    if capacity < S:
        merged = [sparse_ops.segment_reduce_sorted(
            *sparse_ops.sort_by_key(flat_rows[m], flat_g[m]), capacity,
            Operators.SUM) for m in range(n)]
        ids = torch.cat([i for i, _ in merged])
        upd = torch.cat([v for _, v in merged])
    else:                               # every slot is a live row
        ids, upd = flat_rows.reshape(-1), flat_g.reshape(n * S, k)
    if group is not None:
        ids, upd = _gather_updates(ids, upd, group)
    in_order = group is not None
    if capacity < S:
        _add_rows(V, ids, -(lr / denom) * upd, in_order)
    else:
        _index_add(V, ids, -(lr / denom) * upd, in_order)
    return (w0, w, V), loss


def _fetch_rows_sharded(Vs, gi):
    """Owner-routed row fetch from a block-sharded table ``Vs`` [n, B,
    k]: every owner sees every member's row ids ``gi`` [n, S], answers
    with the rows it holds (zeros elsewhere), and ``all_to_all``
    delivers the [n_owner, n_requester, S, k] blocks; the owners'
    answers sum to the complete rows (each id has one owner). Returns
    ([n, S, k] rows, owner [n, S], the members' ranks [n, 1, 1])."""
    n, B = Vs.shape[:2]
    owner = torch.div(gi, B, rounding_mode="floor")
    me = flat_index(n, Vs.device).reshape(n, 1, 1)
    mine = owner.unsqueeze(0) == me                       # [own, req, S]
    local = torch.where(mine, gi.unsqueeze(0) - me * B, 0)
    contrib = Vs[me, local]                               # [own, req, S, k]
    contrib = torch.where(mine.unsqueeze(-1), contrib, 0.0)
    recv = all_to_all(contrib)                            # [req, own, S, k]
    return torch.sum(recv, dim=1), owner, me


class _Route(NamedTuple):
    """How :func:`_fetch_rows_across` sent this rank's row ids: ``order``
    sorts the local slots by owning rank, ``send`` / ``recv`` are the
    all-to-all's split sizes, ``local`` the received ids as rows of this
    process's blocks."""

    order: torch.Tensor
    send: list
    recv: list
    local: torch.Tensor


def _fetch_rows_across(V, gi, base: int, span: int, group):
    """Owner-routed row fetch from a table sharded over the processes of
    ``group``: this process holds rows ``[base, base + span)`` of the
    padded table as ``V`` [span, k] (its members' blocks), and ``gi``
    [n_local, S] are its members' row ids. Each id travels only to the
    process that owns it (rank ``id // span``) and its row comes back: an
    all-to-all of the ids with split sizes, then one of the rows
    (``comm.distributed.all_to_all_rows``; the one-process form's dense
    [n, n, S, k] blocks would move n times the bytes). Returns ([n_local,
    S, k] rows, the :class:`_Route` for the gradients' return)."""
    world = torch.distributed.get_world_size(group)
    ids = gi.reshape(-1)
    dest = torch.div(ids, span, rounding_mode="floor")
    order = torch.sort(dest, stable=True)[1]
    counts = torch.bincount(dest, minlength=world)
    send = counts.tolist()
    recv = exchange_counts(counts, group)
    local = all_to_all_rows(ids[order], send, recv, group) - base
    back = all_to_all_rows(V[local], recv, send, group)
    rows = torch.empty_like(back)
    rows[order] = back
    return rows.reshape(gi.shape + (V.shape[1],)), _Route(order, send, recv,
                                                          local)


def _return_grads_across(gE, route: _Route, group):
    """The gradient rows ``gE`` [L, k] of the fetched slots back to the
    processes that own them, along :func:`_fetch_rows_across`'s route:
    the rows this process owns, aligned with ``route.local``."""
    return all_to_all_rows(gE[route.order], route.send, route.recv, group)


def _merge_owned(block, ids, g, C: int, scale, in_order: bool = False):
    """A member's merge: the received gradient rows ``g`` of its local
    rows ``ids`` (SENTINEL where another member owns the slot; those
    are dropped first), sorted and segment-reduced into ``C`` slots (in
    one fixed order on a card with ``in_order``), then added into its
    ``block`` scaled by ``scale``."""
    own = ids != sparse_ops.SENTINEL
    li, lv = sparse_ops.segment_reduce_sorted(
        *sparse_ops.sort_by_key(ids[own], g[own]), C, Operators.SUM,
        in_order)
    _add_rows(block, li, scale * lv)


def train_step_sparse_sharded(params, batch, cfg: FMConfig, group=None,
                              first: int = 0):
    """One step with the embedding table sharded over the members:
    member m owns rows ``[m * B, (m + 1) * B)`` of the padded table. On
    one process ``params[2]`` is the whole [n * B, k] table; over the
    processes of ``group`` it is this process's blocks [n_local * B, k],
    its members starting at global member ``first``. Updates the table in
    place; returns (params, loss)."""
    feats, fields = batch[0], batch[1]
    V = params[2]
    rows = _slot_rows(feats, fields, cfg)      # [n_local, per, K(, K)]
    n = rows.shape[0]
    S = rows[0].numel()
    k = V.shape[1]
    B = V.shape[0] // n
    Vs = V.view(n, B, k)
    gi = rows.reshape(n, S)
    n_all = n if group is None else n * torch.distributed.get_world_size(
        group)
    C = min(n_all * S, B)
    lr = cfg.learning_rate

    if group is not None:
        E, route = _fetch_rows_across(V, gi, first * B, n * B, group)
        loss, g0, gw, gE, denom = _sparse_grads(
            params, batch, cfg, E.reshape(rows.shape + (k,)), group)
        recvg = _return_grads_across(gE.reshape(n * S, k), route, group)
        w0, w = _update_linear(params[0], params[1], g0, gw, denom, cfg)
        if cfg.l2:
            V.mul_(1.0 - lr * cfg.l2)
        member = torch.div(route.local, B, rounding_mode="floor")
        for m in range(n):
            ids = torch.where(member == m, route.local - m * B,
                              sparse_ops.SENTINEL).to(torch.int32)
            _merge_owned(Vs[m], ids, recvg, C, -(lr / denom))
        return (w0, w, V), loss

    # forward: owner-routed row fetch
    E_flat, owner, me = _fetch_rows_sharded(Vs, gi)
    loss, g0, gw, gE, denom = _sparse_grads(
        params, batch, cfg, E_flat.reshape(rows.shape + (k,)))

    # backward: gradient rows routed to their owners
    send = torch.where(
        (owner.unsqueeze(1) == me.reshape(1, n, 1)).unsqueeze(-1),
        gE.reshape(n, 1, S, k), 0.0)                      # [src, dst, S, k]
    recvg = all_to_all(send)                              # [dst, src, S, k]
    # received row (j, s) carries my local row id iff I own gi[j, s]
    loc_ids = torch.where(owner.unsqueeze(0) == me, gi.unsqueeze(0) - me * B,
                          sparse_ops.SENTINEL).to(torch.int32)
    w0, w = _update_linear(params[0], params[1], g0, gw, denom, cfg)
    if cfg.l2:
        V.mul_(1.0 - lr * cfg.l2)
    for m in range(n):
        # only the rows member m owns enter its merge: the rest carry
        # SENTINEL, which the reference sorts along in its static shapes
        # and whose segment it discards; here they are dropped first
        # (they would all add into one discarded slot)
        _merge_owned(Vs[m], loc_ids[m].reshape(-1),
                     recvg[m].reshape(n * S, k), C, -(lr / denom))
    return (w0, w, V), loss


# ----------------------------------------------------------------------
# the steps over a member list (a list mesh): ``params`` one (w0, w, V)
# a member on its device, ``batch`` a tuple of member lists
# ----------------------------------------------------------------------
def _member_batches(batch):
    """A tuple of member lists as one batch tuple a member."""
    return list(zip(*batch))


def train_step_dense_members(params, batch, cfg: FMConfig):
    """:func:`train_step_dense` over a member list: each member's
    gradients over its rows, the table's folded in rank order on member 0's
    device (``ops.collectives.allreduce``, the reference's ``psum``) and
    the rest by :func:`_fold_member_sums`; every member applies the same
    update to its replica. Returns (params, member 0's loss)."""
    sums = [_grad_sums(p, lambda *q, b=b: _score(q, *b[:4], cfg), b[4],
                       b[5], cfg)
            for p, b in zip(params, _member_batches(batch))]
    gV = coll.allreduce([g[2] for _, _, g in sums])
    folded = _fold_member_sums(sums)
    out = []
    for (w0, w, V), (_, g0, gw, denom), gVm in zip(params, folded, gV):
        w0, w = _update_linear(w0, w, g0, gw, denom, cfg)
        out.append((w0, w, V - cfg.learning_rate * (gVm / denom
                                                    + cfg.l2 * V)))
    return out, folded[0][0]


def train_step_sparse_members(params, batch, cfg: FMConfig, capacity: int):
    """:func:`train_step_sparse` over a member list: each member's (row,
    gradient row) slots, merged on its device into ``capacity`` slots
    when that is below its slot count S, are concatenated in rank order
    onto every member (``ops.collectives.allgather``, the reference's
    tiled ``all_gather``) and added into every member's replica; the
    merges and the adds run in one fixed order. Updates the replicas in
    place; returns (params, member 0's loss)."""
    sums, ids, upd = [], [], []
    for (w0, w, V), b in zip(params, _member_batches(batch)):
        rows = _slot_rows(b[0], b[1], cfg)            # [per, K(, K)]
        S, k = rows.numel(), V.shape[1]
        s = _grad_sums((w0, w, _gather_slots(V, rows)), _slot_score(b, cfg),
                       b[4], b[5], cfg)
        sums.append(s)
        i, u = rows.reshape(S), s[2][2].reshape(S, k)
        if capacity < S:
            i, u = sparse_ops.segment_reduce_sorted(
                *sparse_ops.sort_by_key(i, u), capacity, Operators.SUM,
                in_order=True)
        ids.append(i)
        upd.append(u)
    ids, upd = coll.allgather(ids), coll.allgather(upd)
    folded = _fold_member_sums(sums)
    lr = cfg.learning_rate
    out = []
    for (w0, w, V), (_, g0, gw, denom), i, u in zip(params, folded, ids,
                                                     upd):
        w0, w = _update_linear(w0, w, g0, gw, denom, cfg)
        if cfg.l2:
            V.mul_(1.0 - lr * cfg.l2)
        if capacity < S:
            _add_rows(V, i, -(lr / denom) * u, in_order=True)
        else:
            _index_add(V, i, -(lr / denom) * u, in_order=True)
        out.append((w0, w, V))
    return out, folded[0][0]


def _fetch_rows_members(blocks, gi):
    """:func:`_fetch_rows_sharded` over a member list: member m's block
    ``blocks[m]`` [B, k] and row ids ``gi[m]`` [S] on its device. Every
    owner gets every member's ids (the list ``allgather``), answers with
    the rows it holds (zeros elsewhere) as [n_req, S, k] -- owner m's
    slice of the packed form's [n_own, n_req, S, k] blocks -- and the list
    ``all_to_all`` delivers them; each member sums its [n_own, S, k]
    answers. Returns (member m's [S, k] rows, every member's ids [n, S]
    on each member's device)."""
    B = blocks[0].shape[0]
    every = coll.allgather(gi, tiled=False)
    contrib = []
    for m, (block, g) in enumerate(zip(blocks, every)):
        mine = torch.div(g, B, rounding_mode="floor") == m      # [req, S]
        # two index tensors, as the packed form's ``Vs[me, local]``: on a
        # card ATen then runs its elementwise index kernel, where one
        # index tensor (``block[idx]``, ``index_select``) takes its row
        # gather, a warp for each 16-byte row (4x the time at Criteo
        # width)
        first = torch.zeros((1, 1), dtype=torch.long, device=block.device)
        rows = block.unsqueeze(0)[first, torch.where(mine, g - m * B, 0)]
        contrib.append(torch.where(mine.unsqueeze(-1), rows, 0.0))
    return [torch.sum(r, dim=0) for r in coll.all_to_all(contrib)], every


def train_step_sparse_sharded_members(params, batch, cfg: FMConfig):
    """:func:`train_step_sparse_sharded` over a member list: member m's
    block [B, k] of the padded table on its device. The rows come through
    :func:`_fetch_rows_members`; each member's gradient rows go to their
    owners through the list ``all_to_all`` ([n_dst, S, k] a member, the
    packed form's blocks), and each owner merges the rows it owns into
    ``C = min(n * S, B)`` slots, in one fixed order, and adds them into
    its block. Updates the blocks in place; returns (params, member 0's
    loss)."""
    members = _member_batches(batch)
    n = len(params)
    B, k = params[0][2].shape
    rows = [_slot_rows(b[0], b[1], cfg) for b in members]
    S = rows[0].numel()
    C = min(n * S, B)
    E, every = _fetch_rows_members([p[2] for p in params],
                                   [r.reshape(S) for r in rows])
    sums, send = [], []
    for (w0, w, _), b, r, e in zip(params, members, rows, E):
        s = _grad_sums((w0, w, e.reshape(r.shape + (k,))),
                       _slot_score(b, cfg), b[4], b[5], cfg)
        sums.append(s)
        dst = torch.arange(n, device=r.device).unsqueeze(1)     # [dst, 1]
        owned = torch.div(r.reshape(1, S), B, rounding_mode="floor") == dst
        send.append(torch.where(owned.unsqueeze(-1),
                                s[2][2].reshape(1, S, k), 0.0))
    recvg = coll.all_to_all(send)                       # [src, S, k] a member
    folded = _fold_member_sums(sums)
    lr = cfg.learning_rate
    out = []
    for m, ((w0, w, block), (_, g0, gw, denom), g, rg) in enumerate(
            zip(params, folded, every, recvg)):
        w0, w = _update_linear(w0, w, g0, gw, denom, cfg)
        if cfg.l2:
            block.mul_(1.0 - lr * cfg.l2)
        # received row (j, s) carries my local row id iff I own gi[j, s]
        loc_ids = torch.where(torch.div(g, B, rounding_mode="floor") == m,
                              g - m * B, sparse_ops.SENTINEL).to(torch.int32)
        _merge_owned(block, loc_ids.reshape(-1), rg.reshape(n * S, k), C,
                     -(lr / denom), in_order=True)
        out.append((w0, w, block))
    return out, folded[0][0]


def _snapshot(params):
    """A copy of the step's parameters (a list of member tuples on a list
    mesh) for early stopping's rollback."""
    if isinstance(params, list):
        return [_snapshot(p) for p in params]
    return tuple(p.clone() for p in params)


def _link(z, cfg: FMConfig):
    return torch.sigmoid(z) if cfg.loss == "logistic" else z


def predict(params, feats, fields, vals, mask, cfg: FMConfig):
    return _link(_score(params, feats, fields, vals, mask, cfg), cfg)


def _stage_params(params, cfg: FMConfig, n_rows_padded: int, device,
                  sharded: bool, copy: bool, block=None):
    """(w0, w, V) from numpy arrays or tensors as f32 tensors on
    ``device``; the table cut to its ``n_rows`` real rows, or padded
    with zero rows to ``n_rows_padded`` when ``sharded``. ``block`` =
    (lo, hi): the rows of the padded table this process holds (a sharded
    table over processes); V is then either a whole table, whose block is
    taken, or a table of fewer than ``n_rows`` rows, which must be the
    block itself (what ``fit`` returns there). ``copy`` leaves the
    caller's tensors untouched by later in-place steps."""
    def put(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        t = a.detach().to(device=device, dtype=torch.float32)
        return t.clone() if copy and t.data_ptr() == a.data_ptr() else t

    w0, w, V = params
    n_rows = n_table_rows(cfg)
    if tuple(V.shape[1:]) != (cfg.k,):
        raise Mp4jError(f"the table must be [{n_rows}, {cfg.k}], got "
                        f"{tuple(V.shape)}")
    if block is not None and V.shape[0] < n_rows:
        if V.shape[0] != block[1] - block[0]:
            raise Mp4jError(
                f"a table of {V.shape[0]} rows is neither the whole "
                f"[{n_rows}, {cfg.k}] table nor this process's "
                f"{block[1] - block[0]}-row block")
        return put(w0), put(w), put(V).contiguous()
    if V.shape[0] < n_rows:
        raise Mp4jError(f"the table must be [{n_rows}, {cfg.k}], got "
                        f"{tuple(V.shape)}")
    lo, hi = (0, n_rows_padded) if block is None else block
    V = put(V[lo: min(hi, n_rows)] if sharded else V[:n_rows])
    if sharded and hi - lo > V.shape[0]:
        V = torch.cat([V, V.new_zeros((hi - lo - V.shape[0], cfg.k))])
    return put(w0), put(w), V.contiguous()


def _block(mesh, n_rows_padded: int):
    """The padded table's rows ``(lo, hi)`` that this process's members
    own on a mesh over processes; None on a one-process mesh."""
    if mesh.group is None:
        return None
    B = n_rows_padded // mesh.n
    return mesh.first * B, (mesh.first + mesh.n_local) * B


def _split_blocks(params, devices, copy: bool):
    """A staged (w0, w, padded table) as one (w0, w, block) a member of a
    list mesh: member m's rows ``[m * B, (m + 1) * B)`` on ``devices[m]``
    (copied with ``copy``; a view where it is the table's own device),
    and a replica of its own of w0 and w."""
    w0, w, V = params
    blocks = V.view(len(devices), -1, V.shape[1])
    return [(w0.to(d, copy=True), w.to(d, copy=True),
             blocks[m].to(d, copy=copy)) for m, d in enumerate(devices)]


def _returned(members, sharded: bool):
    """What ``fit`` returns on a list mesh: member 0's ``(w0, w, V)``, or
    with the sharded table ``(w0, w, blocks)``, the members' blocks."""
    w0, w, V = members[0]
    return (w0, w, [m[2] for m in members]) if sharded else (w0, w, V)


def params_from_numpy(params, cfg: FMConfig,
                      table_sharding: str = "replicated", mesh=None):
    """The reference's parameters ``(w0, w, V)`` as numpy arrays (as
    ``ytk_mp4j_tpu`` trains or loads them; the table [n_rows, k]) as the
    port's, on ``mesh``'s device (default: one member on ``cuda:0``),
    the table padded for ``mesh``'s member count when sharded; on a mesh
    over processes each process takes its own members' blocks; on a list
    mesh, as ``fit`` returns them there: the whole table on member 0's
    device, or the list of the members' blocks, each on its device."""
    mesh = make_mesh(1) if mesh is None else mesh
    n_rows = n_table_rows(cfg)
    padded = -(-n_rows // mesh.n) * mesh.n
    sharded = table_sharding == "sharded"
    staged = _stage_params(params, cfg, padded, mesh.device, sharded,
                           copy=True,
                           block=_block(mesh, padded) if sharded else None)
    if sharded and mesh.is_list:
        return _returned(_split_blocks(staged, mesh.devices, False), True)
    return staged


class FMTrainer(DataParallelTrainer):
    """Data-parallel FM/FFM over a mesh of members (``mesh``, or
    ``n_devices`` members on ``device``; ``cuda:0`` unless
    ``device="cpu"``). ``sparse_grads=True`` takes the sparse gradient
    path; ``table_sharding="sharded"`` shards the table over the
    members (it rides the sparse path)."""

    TABLE_SHARDINGS = ("replicated", "sharded")

    def __init__(self, cfg: FMConfig, mesh=None, n_devices=None,
                 device=None, sparse_grads: bool = False,
                 sparse_capacity: int | None = None,
                 table_sharding: str = "replicated"):
        super().__init__(mesh, n_devices, device)
        self.cfg = cfg
        self.sparse_grads = sparse_grads
        self.sparse_capacity = sparse_capacity
        if table_sharding not in self.TABLE_SHARDINGS:
            raise Mp4jError(
                f"table_sharding must be one of {self.TABLE_SHARDINGS}")
        if table_sharding == "sharded" and not sparse_grads:
            raise Mp4jError(
                "table_sharding='sharded' rides the sparse-gradient "
                "path; pass sparse_grads=True")
        if sparse_capacity is not None and (
                table_sharding == "sharded" or not sparse_grads):
            raise Mp4jError(
                "sparse_capacity applies to the replicated sparse path "
                "only (sparse_grads=True, table_sharding='replicated'); "
                "the sharded step sizes its buffers as "
                "C = min(n_shards * batch_slots, table_rows) and the "
                "dense step has no capacity at all")
        self.table_sharding = table_sharding
        self.eval_history_: list[float] = []
        self.replicas_ = None

    @property
    def n_rows(self) -> int:
        """Embedding-table rows: |V| for FM, |V| * n_fields for FFM."""
        return n_table_rows(self.cfg)

    @property
    def n_rows_padded(self) -> int:
        """Table rows padded to a multiple of the member count (the
        sharded table holds B = n_rows_padded / n rows a member; the
        padding rows are never referenced)."""
        n = self.n_shards
        return -(-self.n_rows // n) * n

    @property
    def _sharded(self) -> bool:
        return self.table_sharding == "sharded"

    def init_params(self, seed: int = 0):
        """(w0, w, V) on the device (member 0's on a list mesh); V drawn
        from numpy's ``default_rng(seed)`` exactly as the reference draws
        it, so both packages start from the same table, bitwise."""
        rng = np.random.default_rng(seed)
        V = (self.cfg.init_scale
             * rng.standard_normal((self.n_rows, self.cfg.k))).astype(
                 np.float32)
        return self._stage_whole(
            (np.zeros((), np.float32),
             np.zeros((self.cfg.n_features,), np.float32), V), copy=False)

    def _stage_whole(self, params, copy: bool = True):
        """(w0, w, V) as one tensor each on the device: the table cut to
        its rows, or padded when sharded (over processes, this process's
        blocks). A list of blocks (what ``fit`` returns with the sharded
        table on a list mesh) is concatenated first."""
        w0, w, V = params
        if isinstance(V, (list, tuple)):
            V = torch.cat([as_tensor(b, torch.float32, self.device)
                           for b in V])
        return _stage_params(
            (w0, w, V), self.cfg, self.n_rows_padded, self.device,
            self._sharded, copy, _block(self.mesh, self.n_rows_padded)
            if self._sharded else None)

    def _place_params(self, params, copy: bool = True):
        """Parameters as the step takes them: (w0, w, V) on the device
        (:meth:`_stage_whole`); on a list mesh, one (w0, w, V) a member on
        its device, a replica of its own of the table or member m's block
        of the sharded one."""
        if not self.mesh.is_list:
            return self._stage_whole(params, copy)
        staged = self._stage_whole(params, copy=False)
        if self._sharded:
            return _split_blocks(staged, self.mesh.devices, copy)
        return self._replicas(staged)

    def _start(self, params, seed: int):
        """The step's parameters at the start of ``fit`` / ``fit_stream``:
        a copy of ``params`` (either package's), or ``init_params(seed)``."""
        if params is not None:
            return self._place_params(params)
        params = self.init_params(seed)
        if self.mesh.is_list:
            return self._place_params(params, copy=False)
        return params

    def _finish(self, params):
        """What ``fit`` returns: the step's parameters, or on a list mesh
        member 0's replica, or with the sharded table (w0, w, the members'
        blocks); the members' parameters stay in ``replicas_``."""
        if not self.mesh.is_list:
            return params
        self.replicas_ = params
        return _returned(params, self._sharded)

    @property
    def _sharded_across(self) -> bool:
        """Whether the sharded table lies in pieces: over the processes
        of a job, or over the devices of a list mesh."""
        return self._sharded and (self.group is not None
                                  or self.mesh.is_list)

    def full_table(self, params) -> np.ndarray:
        """The complete [n_rows, k] embedding table on the host, whatever
        the sharding (the serve/save shape): a list mesh's blocks are
        gathered on member 0's device. A collective where the table is
        sharded over processes: every rank gets the gathered table."""
        V = params[2]
        if self._sharded_across:
            V = self._gather_rows(V)
        return as_numpy(V)[: self.n_rows]

    def save_params(self, path: str, params) -> None:
        """Persist with the table in its portable [n_rows, k] shape (a
        sharded table is gathered and unpadded first, so the file loads at
        any member count, in either package); only rank 0 of a job
        writes."""
        super().save_params(path, (params[0], params[1],
                                   self.full_table(params)))

    def _step(self, per_shard_slots: int):
        """The step for a batch of ``per_shard_slots`` slots a member.
        The sparse capacity is computed anew for every batch shape: a
        stale, smaller one would drop gradient rows silently."""
        cfg = self.cfg
        group = self.group
        listed = self.mesh.is_list
        if self._sharded:
            if listed:
                return lambda p, b: train_step_sparse_sharded_members(p, b,
                                                                      cfg)
            first = self.mesh.first
            return lambda p, b: train_step_sparse_sharded(p, b, cfg, group,
                                                          first)
        if not self.sparse_grads:
            if listed:
                return lambda p, b: train_step_dense_members(p, b, cfg)
            return lambda p, b: train_step_dense(p, b, cfg, group)
        cap = self.sparse_capacity
        if cap is None:
            # global unique touched rows can't exceed the step's slots,
            # nor the table size
            bound = per_shard_slots * self.n_shards
            if cfg.model == "ffm":
                bound *= cfg.max_nnz
            cap = min(self.n_rows, bound)
        if listed:
            return lambda p, b: train_step_sparse_members(p, b, cfg, cap)
        return lambda p, b: train_step_sparse(p, b, cfg, cap, group)

    def _check_instances(self, feats, fields):
        """Id-range validation of fit and predict inputs (numpy, or
        tensors: one fetch of their extremes)."""
        cfg = self.cfg
        if feats.ndim != 2 or feats.shape[1] > cfg.max_nnz:
            raise Mp4jError(
                f"feats must be [N, K<={cfg.max_nnz}], got "
                f"{tuple(feats.shape)}")
        if isinstance(feats, torch.Tensor):
            if feats.numel() == 0:
                return
            lo, hi, flo, fhi = torch.stack(
                [feats.min(), feats.max(), fields.min(),
                 fields.max()]).tolist()
        else:
            lo, hi = feats.min(initial=0), feats.max(initial=0)
            flo, fhi = fields.min(initial=0), fields.max(initial=0)
        if lo < 0 or hi >= cfg.n_features:
            raise Mp4jError("feature id out of range")
        if cfg.model == "ffm" and (flo < 0 or fhi >= cfg.n_fields):
            raise Mp4jError("field id out of range")

    def _stage_instances(self, feats, fields, vals, per=None,
                         local: bool = False):
        """Validate padded-sparse instances, pad the slot axis to
        max_nnz, derive the nonzero mask (padded slots carry value 0),
        on the device: (feats, fields, vals, mask) [N, max_nnz]; with
        ``local``, only this process's rows of them (see
        :meth:`_row_span`)."""
        if isinstance(feats, torch.Tensor):
            fields = as_tensor(fields, torch.int32, feats.device)
        else:
            feats = np.asarray(feats, np.int32)
            fields = np.asarray(as_numpy(fields), np.int32)
        if not isinstance(vals, torch.Tensor):
            vals = np.asarray(vals, np.float32)
        if fields.shape != feats.shape:
            raise Mp4jError(
                f"fields {tuple(fields.shape)} must match feats "
                f"{tuple(feats.shape)}")
        self._check_instances(feats, fields)
        if local:
            N = feats.shape[0]
            feats, fields, vals = (self._local_rows(a, N, per)
                                   for a in (feats, fields, vals))
        feats = as_tensor(feats, torch.int32, self.device)
        fields = as_tensor(fields, torch.int32, self.device)
        vals = as_tensor(vals, torch.float32, self.device)
        padK = self.cfg.max_nnz - feats.shape[1]
        if padK:
            feats, fields, vals = (
                torch.nn.functional.pad(a, (0, padK))
                for a in (feats, fields, vals))
        return feats, fields, vals, (vals != 0).to(torch.float32)

    def _labels(self, y, N: int, per=None, local: bool = False):
        """Labels [N] on the device (this process's rows of them with
        ``local``)."""
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y, np.float32)
        if tuple(y.shape) != (N,):
            raise Mp4jError(f"y must be [N={N}], got {tuple(y.shape)}")
        if local:
            y = self._local_rows(y, N, per)
        return as_tensor(y, torch.float32, self.device)

    def _stage_batch(self, feats, fields, vals, y, weights, per=None):
        """This process's members' rows of padded-sparse instances as
        member tensors ``(feats, fields, vals, mask, y, sw)``."""
        N = len(feats)
        staged = self._stage_instances(feats, fields, vals, per, local=True)
        y = self._labels(y, N, per, local=True)
        real = y.shape[0]
        arrays, per, sw = self._pad_rows(list(staged) + [y], N, per)
        if weights is not None:
            sw[:real] *= self._weights(weights, N, per)
        return self._members(arrays + [sw], per)

    def shard_data(self, feats, fields, vals, y, sample_weight=None):
        """Pad and shard padded-sparse instances (numpy or tensors):
        returns ``(feats, fields, vals, mask, y, sw)`` as member tensors
        ``[n_local, per, ...]`` (this process's members; on a list mesh,
        lists of member m's ``[per, ...]`` rows on ``devices[m]``).
        feats/fields:
        [N, K] int (K <= max_nnz); vals: [N, K] float; y: [N].
        ``sample_weight`` ([N]) scales each example's loss and gradient
        (the step normalizes by the job's weight sum, so integer weights
        train exactly like row duplication); padding rows weigh 0."""
        return self._stage_batch(feats, fields, vals, y, sample_weight)

    def fit(self, feats, fields, vals, y, n_steps: int = 100, params=None,
            seed: int = 0, eval_set=None,
            early_stopping_rounds: int | None = None,
            sample_weight=None, comm=None):
        """Full-batch training; returns (params, losses as numpy).

        ``eval_set=(feats_va, fields_va, vals_va, y_va)`` evaluates the
        held-out loss after every step (``self.eval_history_``, the same
        on every rank); ``early_stopping_rounds=k`` stops after k
        non-improving steps and returns the best step's params;
        ``sample_weight`` ([N]) weights each example (integer weights ==
        row duplication). ``params`` (tensors or numpy, either package's)
        are copied, never written to.

        ``comm`` (an mp4j comm; every rank calls ``fit`` together) sums
        each step's training loss across the comm's ranks: the mean
        history lands in ``self.sync_loss_history_``. Under
        ``MP4J_OVERLAP=1`` the exchanges are drained at the loop's end
        (the same results, bit for bit)."""
        if early_stopping_rounds is not None and eval_set is None:
            raise Mp4jError("early_stopping_rounds requires an eval_set")
        batch = self.shard_data(feats, fields, vals, y,
                                sample_weight=sample_weight)
        step = self._step(int(batch[0][0].shape[0]) * self.cfg.max_nnz)
        params = self._start(params, seed)
        va = None if eval_set is None else self._prep_eval(*eval_set)
        stopper = EarlyStopper(early_stopping_rounds)
        self.eval_history_ = stopper.history
        exchanger = StepStatsExchanger(comm)
        losses = []
        for i in range(n_steps):
            params, loss = step(params, batch)
            losses.append(loss)
            exchanger.submit_loss(loss)
            if va is not None and stopper.update(
                    self._eval_loss(params, va), i,
                    state=(_snapshot(params)
                           if early_stopping_rounds is not None else None)):
                if stopper.best_state is not None:
                    params = stopper.best_state
                    losses = losses[:stopper.best_round + 1]
                break
        self.sync_loss_history_ = exchanger.loss_history()
        params = self._finish(params)
        if not losses:
            return params, np.zeros(0, np.float32)
        return params, torch.stack(losses).cpu().numpy()

    def fit_stream(self, batches, params=None, seed: int = 0,
                   batch_rows: int | None = None,
                   max_in_flight: int = 2):
        """Chunked (out-of-core) training: one step per ``(feats,
        fields, vals, y)`` chunk (or 5-tuples with per-chunk instance
        weights; ``utils.libsvm.read_libsvm`` streams them from disk).

        Every chunk is padded to ``batch_rows`` rows (default: the first
        chunk's size rounded up to the member count) with zero-weight
        rows; a larger chunk raises. Feeding the full dataset as one
        chunk E times runs the same steps as ``fit(n_steps=E)``. The
        loop is double-buffered (``DataParallelTrainer._stream_fit``):
        at most ``max_in_flight`` steps are queued, 0 runs them one
        after another. Over processes every rank streams the same
        chunks and stages its members' rows of each. Returns (params,
        per-chunk losses)."""
        state = [self._start(params, seed)]

        def dispatch(staged):
            batch, per_shard_slots = staged
            state[0], loss = self._step(per_shard_slots)(state[0], batch)
            return loss

        losses = self._stream_fit(batches, self._stage_stream_chunk,
                                  dispatch, batch_rows, max_in_flight)
        return self._finish(state[0]), losses

    def _stage_stream_chunk(self, chunk, batch_rows: int | None):
        """Host half of one stream step: validate, copy to the device,
        pad to ``batch_rows`` (resolved from the first chunk). Returns
        ((member batch, slots a member), batch_rows)."""
        N = len(chunk[0])
        if batch_rows is None:
            batch_rows = -(-N // self.n_shards) * self.n_shards
        per = self._stream_span(N, batch_rows)
        batch = self._stage_batch(*chunk[:4], chunk[4] if len(chunk) > 4
                                  else None, per)
        return (batch, per * self.cfg.max_nnz), batch_rows

    def _prep_eval(self, feats, fields, vals, y):
        """Stage a held-out batch once for the per-step evaluation."""
        staged = self._stage_instances(feats, fields, vals)
        return staged + (self._labels(y, staged[0].shape[0]),)

    def _eval_loss(self, params, va) -> float:
        feats, fields, vals, mask, y = va
        if self._sharded_across:
            z = self._scores_sharded(params, feats, fields, vals, mask)
        else:
            z = _score(params[0] if self.mesh.is_list else params, feats,
                       fields, vals, mask, self.cfg)
        return float(torch.mean(per_example_loss(z, y, self.cfg.loss)))

    def _scores_sharded(self, params, feats, fields, vals, mask):
        """Scores of staged instances [N, ...] from the sharded table by
        the owner-routed row fetch (no member reads a row it does not
        own), one member a block of rows; over processes each rank scores
        its members' rows and every rank gets all N scores (a
        collective); over a list mesh each member scores its rows on its
        device and the scores are gathered on member 0's."""
        N = feats.shape[0]
        cfg = self.cfg
        local = [self._local_rows(a, N) for a in (feats, fields, vals, mask)]
        (f, fl, v, m), per, _ = self._pad_rows(local, N)
        f, fl, v, m = self._members([f, fl, v, m], per)
        if self.mesh.is_list:
            rows = [_slot_rows(a, b, cfg) for a, b in zip(f, fl)]
            E, _ = _fetch_rows_members([p[2] for p in params],
                                       [r.reshape(-1) for r in rows])
            z = [_score_from_slots(p[0], p[1], e.reshape(r.shape + (cfg.k,)),
                                   a, b * c, cfg)
                 for p, r, e, a, b, c in zip(params, rows, E, f, v, m)]
            return self._gather_rows(z)[:N]
        w0, w, V = params
        n = f.shape[0]
        rows = _slot_rows(f, fl, cfg)
        gi = rows.reshape(n, -1)
        if self.group is None:
            E, _, _ = _fetch_rows_sharded(V.view(n, -1, cfg.k), gi)
        else:
            E, _ = _fetch_rows_across(V, gi, self.mesh.first * V.shape[0]
                                      // n, V.shape[0], self.group)
        z = _score_from_slots(w0, w, E.reshape(rows.shape + (cfg.k,)),
                              f, v * m, cfg)
        return self._gather_rows(z.reshape(-1))[:N]

    def predict(self, params, feats, fields, vals):
        """Probabilities (logistic) or scores (squared) of the instances,
        a tensor [N] on the device. ``params`` may be either package's,
        tensors or numpy. A collective on a table sharded over
        processes."""
        feats, fields, vals, mask = self._stage_instances(feats, fields,
                                                          vals)
        params = (self._place_params(params, copy=False) if self._sharded
                  else self._stage_whole(params, copy=False))
        with torch.no_grad():
            if self._sharded:
                return _link(self._scores_sharded(params, feats, fields,
                                                  vals, mask), self.cfg)
            return predict(params, feats, fields, vals, mask, self.cfg)


# ----------------------------------------------------------------------
# serve adapter: the pull-mode sharded entry point
# ----------------------------------------------------------------------
class FMServable:
    """Row-pull serve adapter for a trained FM / FFM model -- the host
    twin of :meth:`FMTrainer._scores_sharded` (the owner-routed row
    fetch): the full table is never materialized on the frontend; a
    batch pulls exactly the rows it touches, owner-routed by ``row_id %
    size`` over the columnar map plane, and hot rows come out of the
    frontend cache instead.

    A pull ROW is one feature's whole serve payload: ``[w[f]]`` + its
    embedding row(s) -- ``1 + k`` floats for FM, ``1 + n_fields * k`` for
    FFM (feature f's rows against every field, flattened). Scoring is per
    example in slot order, so batched and sequential serve predictions
    are bitwise identical by construction. ``params`` are ``(w0, w, V)``
    tensors on any device or numpy arrays; a table padded for a sharded
    trainer on one process is cut to its first ``n_features * nf`` rows.
    """

    kind = "pull"

    def __init__(self, params, cfg: FMConfig):
        w0, w, V = params
        self.cfg = cfg
        self.family = cfg.model
        self._w0 = float(as_numpy(w0))
        self._w = np.asarray(as_numpy(w), np.float32)
        V = np.asarray(as_numpy(V), np.float32)
        nf = cfg.n_fields if cfg.model == "ffm" else 1
        if V.shape[0] < cfg.n_features * nf:
            raise Mp4jError(
                f"FMServable needs the whole [{cfg.n_features * nf}, "
                f"{cfg.k}] table, got {tuple(V.shape)} (a table sharded "
                "over processes: pass FMTrainer.full_table(params))")
        # [n_features, nf * k]: feature f's embedding payload
        self._E = np.ascontiguousarray(
            V[:cfg.n_features * nf].reshape(cfg.n_features,
                                            nf * cfg.k))
        self.n_rows = cfg.n_features
        self.row_width = 1 + nf * cfg.k
        self.resp_width = 1

    def row_ids(self, req) -> np.ndarray:
        """Unique features an instance's ACTIVE slots touch."""
        feats, _fields, vals = req
        return np.unique(np.asarray(feats, np.int64)[
            np.asarray(vals, np.float32) != 0])

    def rows(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        return np.concatenate(
            [self._w[ids, None], self._E[ids]],
            axis=1).astype(np.float64)

    def predict_sharded(self, reqs, rowmap) -> list:
        """Score a batch from pulled rows, one example at a time in slot
        order (the FFM pair loop's order is what makes batched equal
        sequential bitwise); a row missing from ``rowmap`` scores as
        zeros."""
        out = []
        k = self.cfg.k
        zero = np.zeros(self.row_width, np.float32)
        for feats, fields, vals in reqs:
            feats = np.asarray(feats, np.int64)
            fields = np.asarray(fields, np.int32)
            vals = np.asarray(vals, np.float32)
            act = np.flatnonzero(vals != 0)
            rows = [rowmap.get(int(feats[a]))
                    for a in act]
            rows = [zero if r is None else r.astype(np.float32)
                    for r in rows]
            z = np.float32(self._w0)
            for r, a in zip(rows, act):
                z += r[0] * vals[a]
            if self.cfg.model == "fm":
                # 0.5 * ((sum_a v_a x_a)^2 - sum_a (v_a x_a)^2) over k
                s = np.zeros(k, np.float32)
                ss = np.zeros(k, np.float32)
                for r, a in zip(rows, act):
                    ex = r[1:] * vals[a]
                    s += ex
                    ss += ex * ex
                z += np.float32(0.5) * np.sum(s * s - ss)
            else:
                # FFM: sum_{a<b} <E[f_a, fl_b], E[f_b, fl_a]> x_a x_b
                for i in range(len(act)):
                    for j in range(i + 1, len(act)):
                        a, b = act[i], act[j]
                        ra = rows[i][1 + fields[b] * k:
                                     1 + (fields[b] + 1) * k]
                        rb = rows[j][1 + fields[a] * k:
                                     1 + (fields[a] + 1) * k]
                        z += np.dot(ra, rb) * vals[a] * vals[b]
            out.append(_serve_link(z, self.cfg.loss))
        return out


def _serve_link(z, loss: str) -> np.ndarray:
    """Overflow-safe host link on a scalar margin."""
    z = float(z)
    if loss == "logistic":
        if z >= 0:
            p = 1.0 / (1.0 + np.exp(-z))
        else:
            e = np.exp(z)
            p = e / (1.0 + e)
        return np.asarray([p], np.float64)
    return np.asarray([z], np.float64)


def servable(params, cfg: FMConfig) -> FMServable:
    """The serve plane's per-family entry point -- covers both
    ``model="fm"`` and ``model="ffm"``."""
    return FMServable(params, cfg)
