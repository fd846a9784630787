"""Data-parallel factorization machines, FM and field-aware FFM (the port
of ``ytk_mp4j_tpu/models/fm.py``), over a mesh of members on one device.

Instances are padded to ``max_nnz`` slots (feature id / field id / value
/ mask; a padded slot has value 0). Member m trains on rows ``[m * per,
(m + 1) * per)``; a batch is a tuple of ``[n, per, ...]`` tensors. The
embedding-gradient exchange takes one of three forms:

- **dense** (default): the full table's gradient, one autograd pass over
  every member's rows (the reference's per-member gradients and
  ``psum``);
- **sparse** (``sparse_grads=True``): autograd with respect to the
  gathered slot rows E, never through the table; each member's (row,
  gradient row) slots, merged locally by sort + segment reduction when
  ``sparse_capacity`` is below the member's slot count, are concatenated
  in rank order (the reference's ``all_gather``) and added into the
  table with one ``index_add_``;
- **sharded table** (``table_sharding="sharded"``): member m owns table
  rows ``[m * B, (m + 1) * B)``. Forward: every member's row ids are
  seen by every owner, each owner answers with the rows it holds, and
  ``ops.collectives.all_to_all`` delivers them ([n, n, S, k] blocks).
  Backward: gradient rows go to their owners by ``all_to_all``, and each
  owner merges the rows it owns of what it received by sort + segment
  reduction into ``C = min(n * S, B)`` slots before adding them into its
  rows.

Scores: FM ``w0 + sum_i w_i x_i + sum_{a<b} <v_a, v_b> x_a x_b`` by the
sum-of-squares identity; FFM ``sum_{a<b} <v_{a, field_b}, v_{b,
field_a}> x_a x_b`` over the K^2 slot pairs.

One copy of the replicated parameters serves every member, so one
autograd pass over all members' rows already gives the sum the
reference's explicit ``psum`` computes; nothing is folded n times.

Intended divergences from the reference:

- the sparse steps update the embedding table in place (the trainer
  copies the parameters it is given once, at the start of ``fit`` and
  ``fit_stream``); the reference's step is functional;
- ``predict`` returns a tensor on the device;
- on a CUDA device the table updates add with atomics, in an order that
  changes from run to run, so two runs of the same steps agree to float
  rounding (rtol 1e-5 on the losses, as the reference's dry run holds
  its stream to its full batch), not bitwise; on the CPU every add runs
  in stream order and ``fit_stream`` over one full-batch chunk per epoch
  equals ``fit`` bitwise;
- no ``comm=`` argument and no ``FMServable``: they ride the host
  planes (ROADMAP queue 1, "What rides the host planes").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models._base import (DataParallelTrainer,
                                             EarlyStopper, as_numpy,
                                             as_tensor, per_example_loss)
from ytk_mp4j_tpu_torch.operators import Operators
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


def _loss_and_grads(leaves, score_fn, y, sw, cfg: FMConfig):
    """The weighted-mean loss over every member's rows and the gradients
    of the weighted loss SUM with respect to ``leaves`` (one autograd
    pass: one copy of the parameters serves every member, so this is
    the sum over members). Returns (loss, grads, denom)."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        sum_loss = torch.sum(
            per_example_loss(score_fn(*leaves), y, cfg.loss) * sw)
        grads = torch.autograd.grad(sum_loss, leaves)
    denom = torch.clamp(torch.sum(sw), min=1.0)
    return sum_loss.detach() / denom, grads, denom


def _update_linear(w0, w, g0, gw, denom, cfg: FMConfig):
    lr = cfg.learning_rate
    return w0 - lr * (g0 / denom), w - lr * (gw / denom + cfg.l2 * w)


def _add_rows(V, rows, upd):
    """``V[rows] += upd`` for the live rows (SENTINEL rows are dropped),
    folding duplicates in stream order on the CPU."""
    keep = rows != sparse_ops.SENTINEL
    V.index_add_(0, rows[keep].long(), upd[keep])


def train_step_dense(params, batch, cfg: FMConfig):
    """One step over member batches ``[n, per, ...]``; the embedding
    gradient is the dense table's. Returns (params, loss)."""
    feats, fields, vals, mask, y, sw = batch
    loss, (g0, gw, gV), denom = _loss_and_grads(
        params, lambda *p: _score(p, feats, fields, vals, mask, cfg),
        y, sw, cfg)
    w0, w, V = params
    w0, w = _update_linear(w0, w, g0, gw, denom, cfg)
    V = V - cfg.learning_rate * (gV / denom + cfg.l2 * V)
    return (w0, w, V), loss


def _sparse_grads(params, batch, cfg: FMConfig, E):
    """Loss and gradients of the sparse steps, differentiated with
    respect to the gathered slot rows ``E``: (loss, g0, gw, gE, denom)."""
    feats, fields, vals, mask, y, sw = batch
    w0, w, _ = params
    xv = vals * mask
    loss, (g0, gw, gE), denom = _loss_and_grads(
        (w0, w, E),
        lambda a, b, c: _score_from_slots(a, b, c, feats, xv, cfg),
        y, sw, cfg)
    return loss, g0, gw, gE, denom


def train_step_sparse(params, batch, cfg: FMConfig, capacity: int):
    """One step whose embedding gradients ride the sparse path: each
    member's (row, gradient row) slots -- merged by sort + segment
    reduction into ``capacity`` slots when that is below the member's
    slot count S -- are concatenated in rank order and added into the
    table, which merges duplicate rows. Updates the table in place;
    returns (params, loss)."""
    feats, fields = batch[0], batch[1]
    V = params[2]
    rows = _slot_rows(feats, fields, cfg)      # [n, per, K(, K)]
    n = rows.shape[0]
    S = rows[0].numel()
    k = V.shape[1]
    loss, g0, gw, gE, denom = _sparse_grads(params, batch, cfg,
                                            _gather_slots(V, rows))
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
        _add_rows(V, torch.cat([i for i, _ in merged]),
                  -(lr / denom) * torch.cat([v for _, v in merged]))
    else:                               # every slot is a live row
        V.index_add_(0, flat_rows.reshape(-1).long(),
                     -(lr / denom) * flat_g.reshape(n * S, k))
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


def train_step_sparse_sharded(params, batch, cfg: FMConfig):
    """One step with the embedding table sharded over the members:
    member m owns rows ``[m * B, (m + 1) * B)`` of ``params[2]`` [n * B,
    k]. Updates the table in place; returns (params, loss)."""
    feats, fields = batch[0], batch[1]
    V = params[2]
    rows = _slot_rows(feats, fields, cfg)      # [n, per, K(, K)]
    n = rows.shape[0]
    S = rows[0].numel()
    k = V.shape[1]
    B = V.shape[0] // n
    Vs = V.view(n, B, k)
    gi = rows.reshape(n, S)

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
    C = min(n * S, B)
    w0, w = _update_linear(params[0], params[1], g0, gw, denom, cfg)
    lr = cfg.learning_rate
    if cfg.l2:
        V.mul_(1.0 - lr * cfg.l2)
    for m in range(n):
        # only the rows member m owns enter its merge: the rest carry
        # SENTINEL, which the reference sorts along in its static shapes
        # and whose segment it discards; here they are dropped first
        # (they would all add into one discarded slot)
        ids = loc_ids[m].reshape(-1)
        own = ids != sparse_ops.SENTINEL
        li, lv = sparse_ops.segment_reduce_sorted(
            *sparse_ops.sort_by_key(ids[own], recvg[m].reshape(n * S, k)[own]),
            C, Operators.SUM)
        _add_rows(Vs[m], li, -(lr / denom) * lv)
    return (w0, w, V), loss


def _link(z, cfg: FMConfig):
    return torch.sigmoid(z) if cfg.loss == "logistic" else z


def predict(params, feats, fields, vals, mask, cfg: FMConfig):
    return _link(_score(params, feats, fields, vals, mask, cfg), cfg)


def _stage_params(params, cfg: FMConfig, n_rows_padded: int, device,
                  sharded: bool, copy: bool):
    """(w0, w, V) from numpy arrays or tensors as f32 tensors on
    ``device``; the table cut to its ``n_rows`` real rows, or padded
    with zero rows to ``n_rows_padded`` when ``sharded``. ``copy``
    leaves the caller's tensors untouched by later in-place steps."""
    def put(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, np.float32))
        t = a.detach().to(device=device, dtype=torch.float32)
        return t.clone() if copy and t.data_ptr() == a.data_ptr() else t

    w0, w, V = (put(p) for p in params)
    n_rows = n_table_rows(cfg)
    if tuple(V.shape[1:]) != (cfg.k,) or V.shape[0] < n_rows:
        raise Mp4jError(f"the table must be [{n_rows}, {cfg.k}], got "
                        f"{tuple(V.shape)}")
    V = V[:n_rows]
    if sharded and n_rows_padded > n_rows:
        V = torch.cat([V, V.new_zeros((n_rows_padded - n_rows, cfg.k))])
    return w0, w, V.contiguous()


def params_from_numpy(params, cfg: FMConfig,
                      table_sharding: str = "replicated", mesh=None):
    """The reference's parameters ``(w0, w, V)`` as numpy arrays (as
    ``ytk_mp4j_tpu`` trains or loads them; the table [n_rows, k]) as the
    port's, on ``mesh``'s device (default: one member on ``cuda:0``),
    the table padded for ``mesh``'s member count when sharded."""
    mesh = make_mesh(1) if mesh is None else mesh
    n_rows = n_table_rows(cfg)
    padded = -(-n_rows // mesh.n) * mesh.n
    return _stage_params(params, cfg, padded, mesh.device,
                         table_sharding == "sharded", copy=True)


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
        """(w0, w, V) on the device; V drawn from numpy's
        ``default_rng(seed)`` exactly as the reference draws it, so both
        packages start from the same table, bitwise."""
        rng = np.random.default_rng(seed)
        V = (self.cfg.init_scale
             * rng.standard_normal((self.n_rows, self.cfg.k))).astype(
                 np.float32)
        return self._place_params(
            (np.zeros((), np.float32),
             np.zeros((self.cfg.n_features,), np.float32), V), copy=False)

    def _place_params(self, params, copy: bool = True):
        return _stage_params(params, self.cfg, self.n_rows_padded,
                             self.device, self._sharded, copy)

    def full_table(self, params) -> np.ndarray:
        """The complete [n_rows, k] embedding table on the host, whatever
        the sharding (the serve/save shape)."""
        return as_numpy(params[2])[: self.n_rows]

    def save_params(self, path: str, params) -> None:
        """Persist with the table in its portable [n_rows, k] shape (a
        sharded table is unpadded first, so the file loads at any member
        count, in either package)."""
        super().save_params(path, (params[0], params[1],
                                   self.full_table(params)))

    def _step(self, per_shard_slots: int):
        """The step for a batch of ``per_shard_slots`` slots a member.
        The sparse capacity is computed anew for every batch shape: a
        stale, smaller one would drop gradient rows silently."""
        cfg = self.cfg
        if self._sharded:
            return lambda p, b: train_step_sparse_sharded(p, b, cfg)
        if not self.sparse_grads:
            return lambda p, b: train_step_dense(p, b, cfg)
        cap = self.sparse_capacity
        if cap is None:
            # global unique touched rows can't exceed the step's slots,
            # nor the table size
            bound = per_shard_slots * self.n_shards
            if cfg.model == "ffm":
                bound *= cfg.max_nnz
            cap = min(self.n_rows, bound)
        return lambda p, b: train_step_sparse(p, b, cfg, cap)

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

    def _stage_instances(self, feats, fields, vals):
        """Validate padded-sparse instances, pad the slot axis to
        max_nnz, derive the nonzero mask (padded slots carry value 0),
        on the device: (feats, fields, vals, mask) [N, max_nnz]."""
        if isinstance(feats, torch.Tensor):
            fields = as_tensor(fields, torch.int32, feats.device)
        else:
            feats = np.asarray(feats, np.int32)
            fields = np.asarray(as_numpy(fields), np.int32)
        if fields.shape != feats.shape:
            raise Mp4jError(
                f"fields {tuple(fields.shape)} must match feats "
                f"{tuple(feats.shape)}")
        self._check_instances(feats, fields)
        feats = as_tensor(feats, torch.int32, self.device)
        fields = as_tensor(fields, torch.int32, self.device)
        vals = as_tensor(vals, torch.float32, self.device)
        padK = self.cfg.max_nnz - feats.shape[1]
        if padK:
            feats, fields, vals = (
                torch.nn.functional.pad(a, (0, padK))
                for a in (feats, fields, vals))
        return feats, fields, vals, (vals != 0).to(torch.float32)

    def _labels(self, y, N: int):
        y = as_tensor(y, torch.float32, self.device)
        if tuple(y.shape) != (N,):
            raise Mp4jError(f"y must be [N={N}], got {tuple(y.shape)}")
        return y

    def shard_data(self, feats, fields, vals, y, sample_weight=None):
        """Pad and shard padded-sparse instances (numpy or tensors):
        returns ``(feats, fields, vals, mask, y, sw)`` as member tensors
        ``[n, per, ...]``. feats/fields: [N, K] int (K <= max_nnz);
        vals: [N, K] float; y: [N]. ``sample_weight`` ([N]) scales each
        example's loss and gradient (the step normalizes by the weight
        sum, so integer weights train exactly like row duplication);
        padding rows weigh 0."""
        feats, fields, vals, mask = self._stage_instances(feats, fields,
                                                          vals)
        N = feats.shape[0]
        y = self._labels(y, N)
        arrays, per, sw = self._pad_rows([feats, fields, vals, mask, y])
        if sample_weight is not None:
            sw[:N] *= self._weights(sample_weight, N)
        return self._members(arrays + [sw], per)

    def fit(self, feats, fields, vals, y, n_steps: int = 100, params=None,
            seed: int = 0, eval_set=None,
            early_stopping_rounds: int | None = None,
            sample_weight=None):
        """Full-batch training; returns (params, losses as numpy).

        ``eval_set=(feats_va, fields_va, vals_va, y_va)`` evaluates the
        held-out loss after every step (``self.eval_history_``);
        ``early_stopping_rounds=k`` stops after k non-improving steps
        and returns the best step's params; ``sample_weight`` ([N])
        weights each example (integer weights == row duplication).
        ``params`` (tensors or numpy, either package's) are copied, never
        written to."""
        if early_stopping_rounds is not None and eval_set is None:
            raise Mp4jError("early_stopping_rounds requires an eval_set")
        batch = self.shard_data(feats, fields, vals, y,
                                sample_weight=sample_weight)
        step = self._step(int(batch[0].shape[1]) * self.cfg.max_nnz)
        params = (self.init_params(seed) if params is None
                  else self._place_params(params))
        va = None if eval_set is None else self._prep_eval(*eval_set)
        stopper = EarlyStopper(early_stopping_rounds)
        self.eval_history_ = stopper.history
        losses = []
        for i in range(n_steps):
            params, loss = step(params, batch)
            losses.append(loss)
            if va is not None and stopper.update(
                    self._eval_loss(params, va), i,
                    state=(tuple(p.clone() for p in params)
                           if early_stopping_rounds is not None else None)):
                if stopper.best_state is not None:
                    params = stopper.best_state
                    losses = losses[:stopper.best_round + 1]
                break
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
        after another. Returns (params, per-chunk losses)."""
        state = [self.init_params(seed) if params is None
                 else self._place_params(params)]

        def dispatch(staged):
            batch, per_shard_slots = staged
            state[0], loss = self._step(per_shard_slots)(state[0], batch)
            return loss

        losses = self._stream_fit(batches, self._stage_stream_chunk,
                                  dispatch, batch_rows, max_in_flight)
        return state[0], losses

    def _stage_stream_chunk(self, chunk, batch_rows: int | None):
        """Host half of one stream step: validate, copy to the device,
        pad to ``batch_rows`` (resolved from the first chunk). Returns
        ((member batch, slots a member), batch_rows)."""
        feats, fields, vals, y = chunk[:4]
        weights = chunk[4] if len(chunk) > 4 else None
        feats, fields, vals, mask = self._stage_instances(feats, fields,
                                                          vals)
        N = feats.shape[0]
        y = self._labels(y, N)
        if batch_rows is None:
            batch_rows = -(-N // self.n_shards) * self.n_shards
        arrays, sw, per = self._pad_stream_rows(
            [feats, fields, vals, mask, y], batch_rows)
        if weights is not None:
            sw[:N] *= self._weights(weights, N)
        return ((self._members(arrays + [sw], per),
                 per * self.cfg.max_nnz), batch_rows)

    def _prep_eval(self, feats, fields, vals, y):
        """Stage a held-out batch once for the per-step evaluation."""
        staged = self._stage_instances(feats, fields, vals)
        return staged + (self._labels(y, staged[0].shape[0]),)

    def _eval_loss(self, params, va) -> float:
        feats, fields, vals, mask, y = va
        z = _score(params, feats, fields, vals, mask, self.cfg)
        return float(torch.mean(per_example_loss(z, y, self.cfg.loss)))

    def _predict_sharded(self, params, feats, fields, vals, mask):
        """Owner-routed row fetch from the sharded table (no member
        reads a row it does not own), one member a block of rows."""
        N = feats.shape[0]
        (f, fl, v, m), per, _ = self._pad_rows([feats, fields, vals, mask])
        f, fl, v, m = self._members([f, fl, v, m], per)
        w0, w, V = params
        n = self.n_shards
        rows = _slot_rows(f, fl, self.cfg)
        E, _, _ = _fetch_rows_sharded(V.view(n, -1, self.cfg.k),
                                      rows.reshape(n, -1))
        z = _score_from_slots(w0, w, E.reshape(rows.shape + (self.cfg.k,)),
                              f, v * m, self.cfg)
        return _link(z, self.cfg).reshape(-1)[:N]

    def predict(self, params, feats, fields, vals):
        """Probabilities (logistic) or scores (squared) of the instances,
        a tensor [N] on the device. ``params`` may be either package's,
        tensors or numpy."""
        feats, fields, vals, mask = self._stage_instances(feats, fields,
                                                          vals)
        params = self._place_params(params, copy=False)
        with torch.no_grad():
            if self._sharded:
                return self._predict_sharded(params, feats, fields, vals,
                                             mask)
            return predict(params, feats, fields, vals, mask, self.cfg)
