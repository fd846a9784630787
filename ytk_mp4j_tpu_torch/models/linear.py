"""Data-parallel linear models (the port of
``ytk_mp4j_tpu/models/linear.py``): linear regression, logistic
regression and multiclass softmax, over a mesh of members on one device
or over the processes of a ``torch.distributed`` job.

Member m trains on rows ``[m * per, (m + 1) * per)``; a batch is a tuple
of ``[n_local, per, ...]`` tensors (this process's members; every member
on a one-process mesh) and the parameters are one replicated copy. One
autograd pass over the local members' rows gives their summed gradient,
the reference's explicit ``psum`` on one process (it casts its parameters
per-member so that the ``psum`` is the only cross-member sum, ``_mean_
loss_grad:62``; here there is nothing to fold twice). Over processes
(``comm.distributed.global_mesh`` / ``hier_global_mesh``) each rank's
weighted loss sum, sample-weight sum and gradients (F + 3 numbers;
F * C + C + 2 for softmax) are gathered and folded in rank order
(``_base.job_sum``), so every rank holds the same parameters bit for
bit. The sums are divided by the job's total sample weight, so padding
rows (weight 0) and integer instance weights train exactly like the
unpadded, duplicated rows.

Over a list mesh (``make_mesh(n, devices=...)``, member m on
``devices[m]``) a batch is a tuple of member lists, each member holds a
replica of its own of ``(w, b)`` and the momentum, and computes its
sums over its own rows on its device (:func:`train_step_members`); the
members' sums are folded in rank order on member 0's device
(``_base.fold_members``, the reference's ``psum``) and every member
applies the same update, so the replicas stay bitwise equal. The fold
is the process path's (one partial a member, in rank order), so on the
CPU a list of n members equals n processes of one member bit for bit;
against the packed mesh, whose one autograd pass sums the members' rows
in another order, it agrees to rounding (rtol 1e-5). ``fit`` and
``fit_stream`` return member 0's replica (every member's stays in
``replicas_``); the eval set, ``predict`` and the returned parameters
live on member 0's device.

Losses: ``squared``, ``logistic`` ({0, 1} labels) and ``softmax`` (w is
[F, C], labels are class ids). L2 is a penalty gradient added before the
momentum update (not on the bias); L1 a proximal shrink after the step.

``fit(comm=)`` (an mp4j comm; every rank calls ``fit`` together) sums
each step's training loss over the comm's ranks into
``sync_loss_history_`` (their mean), through ``_base.StepStatsExchanger``
(``MP4J_OVERLAP=1`` moves only the wait).

:class:`LinearServable` (:func:`servable`) is the serve plane's pull-mode
adapter (``serve/dispatcher.py``): it scores on the host in numpy, one
example at a time in slot order, as the reference does.

Intended divergences from the reference: ``predict`` returns a tensor on
the device; :class:`LinearServable` takes the port's tensors (on any
device: it keeps a detached float32 host copy) or numpy arrays, where the
reference fetches its arrays with ``jax.device_get``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.models._base import (DataParallelTrainer,
                                             EarlyStopper,
                                             StepStatsExchanger, as_numpy,
                                             as_tensor, fold_members,
                                             job_sum, per_example_loss,
                                             stage_softmax_labels)

LOSSES = ("squared", "logistic", "softmax")


@dataclass(frozen=True)
class LinearConfig:
    n_features: int
    loss: str = "squared"
    n_classes: int = 2          # used by loss="softmax" only
    learning_rate: float = 0.1
    l1: float = 0.0
    l2: float = 0.0
    momentum: float = 0.0

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise Mp4jError(f"loss must be one of {LOSSES}, got {self.loss!r}")
        if self.loss == "softmax" and self.n_classes < 2:
            raise Mp4jError("softmax needs n_classes >= 2")


def _grad_sums(params, x, y, sw, cfg: LinearConfig):
    """The weighted loss sum (data term only), the weight sum and the
    loss sum's gradient over the rows ``x`` [..., F]: (sum_loss, sw_sum,
    gw, gb)."""
    w, b = (p.detach().requires_grad_(True) for p in params)
    with torch.enable_grad():
        z = x @ w + b
        sum_loss = torch.sum(per_example_loss(z, y, cfg.loss) * sw)
        gw, gb = torch.autograd.grad(sum_loss, (w, b))
    return sum_loss.detach(), torch.sum(sw), gw, gb


def _means(sum_loss, sw_sum, gw, gb):
    """Sums divided by the weight sum: (loss, (gw, gb))."""
    denom = torch.clamp(sw_sum, min=1.0)
    return sum_loss / denom, (gw / denom, gb / denom)


def _mean_loss_grad(params, x, y, sw, cfg: LinearConfig, group=None):
    """The weighted-mean loss (data term only) and its gradient over the
    local members' rows ``x`` [..., F]; with a process ``group``, the
    job's: every rank's sums folded in rank order and divided by the
    job's weight sum."""
    sum_loss, sw_sum, gw, gb = _grad_sums(params, x, y, sw, cfg)
    if group is not None:
        flat = job_sum(torch.cat([sum_loss.reshape(1), sw_sum.reshape(1),
                                  gw.reshape(-1), gb.reshape(-1)]), group)
        sum_loss, sw_sum = flat[0], flat[1]
        gw = flat[2: 2 + gw.numel()].reshape(gw.shape)
        gb = flat[2 + gw.numel():].reshape(gb.shape)
    return _means(sum_loss, sw_sum, gw, gb)


def _update(params, vel, grads, cfg: LinearConfig):
    """The momentum step with L2 and L1 from the mean gradients:
    (params, vel)."""
    gw, gb = grads
    w, b = params
    gw = gw + cfg.l2 * w                      # L2 penalty (not on bias)
    vw, vb = vel
    vw = cfg.momentum * vw + gw
    vb = cfg.momentum * vb + gb
    w = w - cfg.learning_rate * vw
    b = b - cfg.learning_rate * vb
    if cfg.l1 > 0.0:
        # proximal shrink keeps the objective smooth for momentum
        shrink = cfg.learning_rate * cfg.l1
        w = torch.sign(w) * torch.clamp(torch.abs(w) - shrink, min=0.0)
    return (w, b), (vw, vb)


def train_step_shard(params, vel, x, y, sw, cfg: LinearConfig, group=None):
    """One optimization step over member batches (this process's members
    of the job of ``group``). Returns (params, vel, loss)."""
    loss, grads = _mean_loss_grad(params, x, y, sw, cfg, group)
    return _update(params, vel, grads, cfg) + (loss,)


def train_step_members(params, vel, x, y, sw, cfg: LinearConfig):
    """:func:`train_step_shard` over a member list (a list mesh):
    ``params`` and ``vel`` are lists of the members' replicas, ``x``,
    ``y``, ``sw`` lists of their rows, each on its member's device. Each
    member's sums over its rows are folded in rank order
    (``_base.fold_members``) and every member applies the same update to
    its replica. Returns (params, vel, member 0's loss)."""
    sums = fold_members([_grad_sums(p, *b, cfg)
                         for p, b in zip(params, zip(x, y, sw))])
    out = []
    for p, v, s in zip(params, vel, sums):
        loss, grads = _means(*s)
        out.append(_update(p, v, grads, cfg) + (loss,))
    return [o[0] for o in out], [o[1] for o in out], out[0][2]


def predict(params, x, cfg: LinearConfig):
    w, b = params
    z = x @ w + b
    if cfg.loss == "logistic":
        return torch.sigmoid(z)
    if cfg.loss == "softmax":
        return torch.softmax(z, dim=-1)
    return z


def _stage_params(params, device):
    return tuple(torch.from_numpy(np.array(p, np.float32)).to(device)
                 if not isinstance(p, torch.Tensor)
                 else p.detach().to(device=device, dtype=torch.float32)
                 for p in params)


def params_from_numpy(params, cfg: LinearConfig, mesh=None):
    """The reference's parameters ``(w, b)`` as numpy arrays (as
    ``ytk_mp4j_tpu`` trains or loads them) as the port's, on ``mesh``'s
    device (default: one member on ``cuda:0``; on a mesh over processes
    every rank holds the whole replicated copy; on a list mesh, member
    0's device, as ``fit`` returns them)."""
    mesh = make_mesh(1) if mesh is None else mesh
    w, b = _stage_params(params, mesh.device)
    want = ((cfg.n_features, cfg.n_classes) if cfg.loss == "softmax"
            else (cfg.n_features,))
    if tuple(w.shape) != want:
        raise Mp4jError(f"w must be {want}, got {tuple(w.shape)}")
    return w, b


class LinearTrainer(DataParallelTrainer):
    """Data-parallel linear/logistic/softmax regression over a mesh of
    members (``mesh``, or ``n_devices`` members on ``device``; ``cuda:0``
    unless ``device="cpu"``; a list mesh), or over processes."""

    def __init__(self, cfg: LinearConfig, mesh=None, n_devices=None,
                 device=None):
        super().__init__(mesh, n_devices, device)
        self.cfg = cfg
        self.eval_history_: list[float] = []
        self.replicas_ = None

    def _start(self, params):
        """The step's (params, vel) from given parameters (either
        package's) or zeros: one replica a member on a list mesh."""
        params = (self.init_params() if params is None
                  else _stage_params(params, self.device))
        vel = tuple(torch.zeros_like(p) for p in params)
        if self.mesh.is_list:
            return self._replicas(params), self._replicas(vel)
        return params, vel

    def _train_step(self, params, vel, batch):
        if self.mesh.is_list:
            return train_step_members(params, vel, *batch, self.cfg)
        return train_step_shard(params, vel, *batch, self.cfg, self.group)

    def _finish(self, params):
        """What ``fit`` returns: the parameters, or member 0's replica on
        a list mesh (the members' replicas stay in ``replicas_``)."""
        if self.mesh.is_list:
            self.replicas_ = params
            return params[0]
        return params

    def init_params(self):
        cfg = self.cfg
        dev = self.device
        if cfg.loss == "softmax":
            # w [F, C], b [C]: ytk-learn's multiclass_linear family
            return (torch.zeros((cfg.n_features, cfg.n_classes),
                                device=dev),
                    torch.zeros((cfg.n_classes,), device=dev))
        return (torch.zeros((cfg.n_features,), device=dev),
                torch.zeros((), device=dev))

    def _stage_x(self, x, what: str = "x"):
        x = as_tensor(x, torch.float32, self.device)
        if x.dim() != 2 or x.shape[1] != self.cfg.n_features:
            raise Mp4jError(
                f"{what} must be [N, {self.cfg.n_features}], got "
                f"{tuple(x.shape)}")
        return x

    def _stage_labels(self, y):
        """Labels must be a flat [N] vector (a column vector would
        broadcast through the loss to [N, N] and train silently on
        garbage); softmax labels are class ids validated in range."""
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        if y.ndim != 1:
            raise Mp4jError(f"y must be 1-D [N], got shape {tuple(y.shape)}")
        if self.cfg.loss != "softmax":
            return as_tensor(y, torch.float32, self.device)
        return as_tensor(stage_softmax_labels(as_numpy(y),
                                              self.cfg.n_classes),
                         torch.int32, self.device)

    def _stage_xy(self, x, y, per: int | None = None):
        """Validate ``x`` [N, F] and labels [N] and stage this process's
        rows of them (see :meth:`_row_span`) on the device; returns (x, y,
        N)."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.cfg.n_features:
            raise Mp4jError(
                f"x must be [N, {self.cfg.n_features}], got "
                f"{tuple(x.shape)}")
        y = self._stage_labels(y)
        N = x.shape[0]
        if y.shape[0] != N:
            raise Mp4jError(f"y must be [N={N}], got {tuple(y.shape)}")
        return (as_tensor(self._local_rows(x, N, per), torch.float32,
                          self.device), self._local_rows(y, N, per), N)

    def shard_data(self, x, y, sample_weight=None):
        """Pad and shard ``x`` [N, F] and ``y`` [N] (numpy or tensors):
        returns member tensors ``(x, y, sw)`` [n_local, per, ...] (this
        process's members; on a list mesh, lists of member m's [per, ...]
        rows on ``devices[m]``). Padding rows weigh 0; ``sample_weight`` ([N])
        scales each example's loss and gradient (integer weights == row
        duplication)."""
        x, y, N = self._stage_xy(x, y)
        real = x.shape[0]
        (x, y), per, sw = self._pad_rows([x, y], N)
        if sample_weight is not None:
            sw[:real] *= self._weights(sample_weight, N)
        return self._members([x, y, sw], per)

    def fit(self, x, y, n_steps: int = 100, params=None, eval_set=None,
            early_stopping_rounds: int | None = None,
            sample_weight=None, comm=None):
        """Run ``n_steps`` full-batch steps; returns (params, losses as
        numpy). ``eval_set=(x_va, y_va)`` tracks the held-out loss per
        step (``self.eval_history_``; every rank evaluates the whole
        set); ``early_stopping_rounds=k`` stops after k non-improving
        steps and returns the best step's params.

        ``comm`` (an mp4j comm; every rank calls ``fit`` together) sums
        each step's training loss across the comm's ranks: the mean
        history lands in ``self.sync_loss_history_`` ([n_steps]). Under
        ``MP4J_OVERLAP=1`` step k's exchange is posted nonblocking and
        drained at the loop's end (the same results, bit for bit)."""
        if early_stopping_rounds is not None and eval_set is None:
            raise Mp4jError("early_stopping_rounds requires an eval_set")
        batch = self.shard_data(x, y, sample_weight=sample_weight)
        params, vel = self._start(params)
        va = None
        if eval_set is not None:
            x_va = self._stage_x(eval_set[0], "eval x")
            y_va = self._stage_labels(eval_set[1])
            if tuple(y_va.shape) != (x_va.shape[0],):
                raise Mp4jError(f"eval y must be [{x_va.shape[0]}], got "
                                f"{tuple(y_va.shape)}")
            va = (x_va, y_va)
        stopper = EarlyStopper(early_stopping_rounds)
        self.eval_history_ = stopper.history
        exchanger = StepStatsExchanger(comm)
        losses = []
        for i in range(n_steps):
            params, vel, loss = self._train_step(params, vel, batch)
            losses.append(loss)
            exchanger.submit_loss(loss)
            if va is not None and stopper.update(
                    self._eval_loss(params, va), i, state=(params, vel)):
                if stopper.best_state is not None:
                    params, vel = stopper.best_state
                    losses = losses[:stopper.best_round + 1]
                break
        self.sync_loss_history_ = exchanger.loss_history()
        params = self._finish(params)
        if not losses:
            return params, np.zeros(0, np.float32)
        return params, torch.stack(losses).cpu().numpy()

    def fit_stream(self, batches, params=None,
                   batch_rows: int | None = None,
                   max_in_flight: int = 2):
        """Chunked (out-of-core) training: one step per ``(x, y)`` chunk
        (or ``(x, y, w)`` with per-chunk instance weights;
        ``utils.libsvm.dense_chunks`` adapts libsvm text). Chunks pad to
        ``batch_rows`` (default: the first chunk, rounded up to the
        member count) with zero-weight rows; momentum threads across
        chunks; the loop double-buffers as ``FMTrainer.fit_stream``
        (``max_in_flight=0`` runs the steps one after another). Returns
        (params, per-chunk losses)."""
        state = list(self._start(params))

        def dispatch(staged):
            state[0], state[1], loss = self._train_step(state[0], state[1],
                                                        staged)
            return loss

        losses = self._stream_fit(batches, self._stage_stream_chunk,
                                  dispatch, batch_rows, max_in_flight)
        return self._finish(state[0]), losses

    def _stage_stream_chunk(self, chunk, batch_rows: int | None):
        """Host half of one stream step: validate, copy to the device,
        pad to ``batch_rows`` (resolved from the first chunk); this
        process's members' rows of it."""
        N = len(chunk[0])
        if batch_rows is None:
            batch_rows = -(-N // self.n_shards) * self.n_shards
        per = self._stream_span(N, batch_rows)
        x, y, _ = self._stage_xy(chunk[0], chunk[1], per)
        real = x.shape[0]
        (x, y), per, sw = self._pad_rows([x, y], N, per)
        if len(chunk) > 2:
            sw[:real] *= self._weights(chunk[2], N, per)
        return self._members([x, y, sw], per), batch_rows

    def _eval_loss(self, params, va) -> float:
        """The held-out loss, on member 0's replica on a list mesh."""
        w, b = params[0] if self.mesh.is_list else params
        x, y = va
        return float(torch.mean(per_example_loss(x @ w + b, y,
                                                 self.cfg.loss)))

    def predict(self, params, x):
        """Probabilities (logistic, softmax) or scores (squared), a
        tensor on the device. ``params`` may be either package's."""
        with torch.no_grad():
            return predict(_stage_params(params, self.device),
                           self._stage_x(x), self.cfg)


# ----------------------------------------------------------------------
# serve adapter: the pull-mode sharded entry point
# ----------------------------------------------------------------------
class LinearServable:
    """Row-pull serve adapter for a trained linear model.

    ``kind="pull"``: the serve dispatcher shards the weight table by
    ``row_id % size`` across the job's ranks and the frontend pulls
    only the rows a batch touches over the columnar map plane. A row
    here is one feature's weight(s): width 1, or ``n_classes`` for
    softmax. Scoring is per example (never across the batch), so
    batched and sequential serve predictions are bitwise identical by
    construction. ``params`` are ``(w, b)`` tensors on any device or
    numpy arrays; the servable holds float32 host copies.
    """

    kind = "pull"
    family = "linear"

    def __init__(self, params, cfg: LinearConfig):
        w, b = params
        self.cfg = cfg
        w = np.asarray(as_numpy(w), np.float32)
        self._w = w if w.ndim == 2 else w[:, None]     # [D, width]
        self._b = np.atleast_1d(np.asarray(as_numpy(b), np.float32))
        self.n_rows = self._w.shape[0]
        self.row_width = self._w.shape[1]
        self.resp_width = (cfg.n_classes if cfg.loss == "softmax"
                           else 1)

    def row_ids(self, req) -> np.ndarray:
        """Unique table rows one request touches (active slots only --
        a zero-valued slot contributes nothing, so its row is never
        pulled)."""
        ids, _fields, vals = req
        return np.unique(np.asarray(ids, np.int64)[
            np.asarray(vals, np.float32) != 0])

    def rows(self, ids) -> np.ndarray:
        """Float64 row vectors for the pull plane (the wire operand of
        ``allreduce_map`` is DOUBLE)."""
        return self._w[np.asarray(ids, np.int64)].astype(np.float64)

    def predict_sharded(self, reqs, rowmap) -> list:
        """Score a batch from pulled rows; one float64 vector per
        request. A row missing from ``rowmap`` scores as zeros -- the
        degraded-but-deliverable contract the dispatcher's status byte
        reports."""
        out = []
        zero = np.zeros(self.row_width, np.float32)
        for ids, _fields, vals in reqs:
            ids = np.asarray(ids, np.int64)
            vals = np.asarray(vals, np.float32)
            z = self._b.astype(np.float32).copy()
            if self.cfg.loss != "softmax":
                z = z[:1].copy()
            for a in range(ids.shape[0]):
                if vals[a] == 0:
                    continue
                row = rowmap.get(int(ids[a]))
                row = zero if row is None else row.astype(np.float32)
                z += row * vals[a]
            out.append(_link(z, self.cfg.loss))
        return out


def _link(z: np.ndarray, loss: str) -> np.ndarray:
    """The prediction link on a host margin vector (numpy mirror of
    :func:`predict`'s heads, overflow-safe)."""
    z = np.asarray(z, np.float32)
    if loss == "logistic":
        p = np.empty_like(z, np.float64)
        pos = z >= 0
        p[pos] = 1.0 / (1.0 + np.exp(-z[pos].astype(np.float64)))
        e = np.exp(z[~pos].astype(np.float64))
        p[~pos] = e / (1.0 + e)
        return p
    if loss == "softmax":
        s = z.astype(np.float64) - z.max()
        e = np.exp(s)
        return e / e.sum()
    return z.astype(np.float64)


def servable(params, cfg: LinearConfig) -> LinearServable:
    """The serve plane's per-family entry point."""
    return LinearServable(params, cfg)
