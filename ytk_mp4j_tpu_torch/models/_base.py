"""Trainer plumbing shared by the model families (the port of
``ytk_mp4j_tpu/models/_base.py``): a trainer over a mesh of members
(``device.make_mesh`` / ``make_hier_mesh``, or a mesh over processes from
``comm.distributed.global_mesh``), rows padded to a multiple of the
member count with zero-weight padding, the per-step statistics exchange
of a trainer handed a ``comm`` (:class:`StepStatsExchanger`), the
streaming loop of the FM and linear ``fit_stream``, and ``.npz`` model
persistence in the reference's format.

Member m's shard is rows ``[m * per, (m + 1) * per)`` of the input (the
reference's ``_put_sharded:327``). On a one-process mesh that is one
contiguous tensor on the mesh's device; on a mesh over processes every
rank passes the same global arrays and stages only its own members' rows
(:meth:`DataParallelTrainer._row_span`), and
:meth:`DataParallelTrainer._gather_rows` gathers every member's rows onto
every rank (``_to_host:371``'s counterpart). Only the GBDT trainer runs
over processes so far; the others refuse such a mesh.

The streaming loop (``_stream_fit``) keeps the reference's double
buffer: while the device runs step k, the host stages chunk k + 1 (numpy
chunks go through pinned memory with a non-blocking copy), at most
``max_in_flight`` steps are queued (the host waits on the CUDA event of
step k - max_in_flight), and the losses are fetched once at the end.

``save_npz`` writes on rank 0 of a ``torch.distributed`` job only (the
reference gates on ``jax.process_index()``), and on every one-process
run.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.operands import Operands


_NP_DTYPES = {torch.int32: np.int32, torch.float32: np.float32}


def as_tensor(a, dtype, device):
    """``a`` (numpy, or a tensor anywhere) as a contiguous ``dtype`` tensor
    on ``device``. A tensor already there is used as it is; numpy input
    is copied, onto a card through pinned memory with a non-blocking
    copy."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    t = torch.from_numpy(np.array(a, dtype=_NP_DTYPES[dtype]))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def as_numpy(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def per_example_loss(z, y, loss: str):
    """Per-example data loss on tensors.

    ``logistic``: softplus-form logloss on {0, 1} labels, written as
    ``max(z, 0) - z y + log1p(exp(-|z|))`` for overflow-free evaluation
    at large |z|; ``max(z, 0)`` is computed as ``(z + |z|) / 2`` (the
    same value), so that autograd gives the loss's gradient at z = 0 as
    sigmoid(0) - y (the reference's autodiff gives -y there).
    ``squared``: 0.5 (z - y)^2. ``softmax``: cross entropy over ``z``
    [N, C] with integer labels ``y``.
    """
    if loss == "logistic":
        return (0.5 * (z + z.abs()) - z * y
                + torch.log1p(torch.exp(-z.abs())))
    if loss == "softmax":
        zy = z.gather(-1, y.long().unsqueeze(-1)).squeeze(-1)
        return torch.logsumexp(z, dim=-1) - zy
    return 0.5 * (z - y) ** 2


def stage_softmax_labels(y, n_classes: int) -> np.ndarray:
    """Validate + cast integer class labels: out-of-range ids would
    select silent garbage, so they must be an error."""
    y = np.asarray(y, np.int32)
    if y.size and (y.min() < 0 or y.max() >= n_classes):
        raise Mp4jError(
            f"softmax labels must lie in [0, {n_classes}), got range "
            f"[{y.min()}, {y.max()}]")
    return y


class StepStatsExchanger:
    """Per-step statistics exchange of the epoch loops (the reference's
    ``StepStatsExchanger:82``).

    When a trainer is handed an mp4j ``comm``, every step's scalar
    statistics (training loss, eval metric) are summed across the comm's
    ranks, so each rank's history reflects the whole job. Two modes,
    selected by ``MP4J_OVERLAP`` (``utils.tuning.overlap_enabled``):

    - blocking (default): ``submit`` / ``submit_map`` run
      ``allreduce_array`` / ``allreduce_map`` inline;
    - overlap (``MP4J_OVERLAP=1``): they post ``iallreduce`` /
      ``iallreduce_map`` and return, and ``drain()`` at the epoch
      boundary waits on ``wait_all()``.

    The exchanged stats are observational, never control flow (early
    stopping reads the local metric), so on == off is bit-exact: the same
    collectives in the same order on every rank, only the wait point
    moves. Values a ``submit`` call returned are defined only after the
    next ``drain()``.
    """

    def __init__(self, comm, overlap: bool | None = None):
        from ytk_mp4j_tpu_torch.utils import tuning

        self.comm = comm
        self.overlap = (tuning.overlap_enabled()
                        if overlap is None else bool(overlap))
        self._arrays: list[np.ndarray] = []
        self._maps: list[dict] = []

    @property
    def active(self) -> bool:
        return self.comm is not None and self.comm.slave_num > 1

    def submit(self, stats: np.ndarray) -> np.ndarray:
        """Sum ``stats`` (float64 [K]) over the comm's ranks, in place;
        the array's values are defined after ``drain()``."""
        stats = np.ascontiguousarray(stats, np.float64)
        if self.active:
            if self.overlap:
                self.comm.iallreduce(stats, Operands.DOUBLE)
            else:
                self.comm.allreduce_array(stats, Operands.DOUBLE)
        self._arrays.append(stats)
        return stats

    def submit_map(self, d: dict) -> dict:
        """Map-plane twin of :meth:`submit` (GBDT's per-round named
        metrics)."""
        if self.active:
            if self.overlap:
                self.comm.iallreduce_map(d, Operands.DOUBLE)
            else:
                self.comm.allreduce_map(d, Operands.DOUBLE)
        self._maps.append(d)
        return d

    def drain(self) -> None:
        """The step/epoch-boundary drain: every submitted exchange is
        complete (and its values defined) after this returns."""
        if self.active and self.overlap:
            self.comm.wait_all()

    def mean_history(self) -> np.ndarray:
        """[n_steps, K] job-wide MEAN of every array submitted so far
        (sum / rank count). Call after :meth:`drain`."""
        if not self._arrays:
            return np.zeros((0, 0), np.float64)
        n = self.comm.slave_num if self.active else 1
        return np.stack(self._arrays) / float(n)

    def mean_map_history(self) -> list[dict]:
        """Per-round job-wide mean of every map submitted so far."""
        n = float(self.comm.slave_num if self.active else 1)
        return [{k: v / n for k, v in d.items()} for d in self._maps]


class EarlyStopper:
    """The early-stopping state machine.

    ``update(metric, round_idx, state)`` records one round; ``state``
    is an arbitrary rollback payload kept only for the best round and
    only when stopping is enabled (a snapshot can pin large device
    buffers). Returns True when ``rounds`` consecutive non-improving
    rounds have passed. NaN metrics never count as improvements, so a
    NaN-only history leaves ``best_round == -1`` (callers keep
    everything in that case rather than truncating to empty).
    """

    _MIN_DELTA = 1e-12

    def __init__(self, rounds: int | None):
        self.rounds = rounds
        self.best_metric = np.inf
        self.best_round = -1
        self.best_state = None
        self.history: list[float] = []

    def update(self, metric: float, round_idx: int, state=None) -> bool:
        self.history.append(metric)
        if metric < self.best_metric - self._MIN_DELTA:
            self.best_metric, self.best_round = metric, round_idx
            if self.rounds is not None:
                self.best_state = state
            return False
        return (self.rounds is not None
                and round_idx - self.best_round >= self.rounds)


def _write_rank() -> bool:
    """Whether this process writes shared files: rank 0 of a job, or a
    process outside any job."""
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)


def save_npz(path: str, cfg, arrays: dict) -> None:
    """Model-persistence writer: the config dataclass (repr of asdict,
    decoded by literal_eval) plus named arrays. Writes through a file
    object so the exact user path is honored (np.savez(path) silently
    appends ".npz"); only rank 0 writes in a ``torch.distributed`` job."""
    from dataclasses import asdict

    if not _write_rank():
        return
    with open(path, "wb") as f:
        np.savez(f, config=np.array(repr(asdict(cfg))), **arrays)


def load_npz(path: str, config_cls):
    """Counterpart of :func:`save_npz`: returns (config instance,
    {name: array}) with pickle disabled."""
    import ast

    with np.load(path, allow_pickle=False) as z:
        cfg = config_cls(**ast.literal_eval(str(z["config"])))
        arrays = {k: z[k] for k in z.files if k != "config"}
    return cfg, arrays


class DataParallelTrainer:
    """Mesh bookkeeping + row sharding shared by the trainers.

    ``mesh`` (from ``device.make_mesh`` / ``make_hier_mesh``) gives the
    members and their device; without one, ``n_devices`` members (default
    1) go on ``device`` (default ``cuda:0``). The reference's default is
    every device, which on the port's one card is one member."""

    # whether the family trains on a mesh over processes
    over_processes = False

    def __init__(self, mesh=None, n_devices=None, device=None):
        if mesh is None:
            mesh = make_mesh(1 if n_devices is None else n_devices, device)
        elif n_devices is not None or device is not None:
            raise Mp4jError("give a mesh, or n_devices and device, not both")
        if mesh.group is not None and not self.over_processes:
            raise Mp4jError(
                f"{type(self).__name__} trains on a one-process mesh; a "
                "mesh over processes is not ported for it yet")
        self.mesh = mesh
        self.device = mesh.device

    @property
    def n_shards(self) -> int:
        return self.mesh.n

    def _row_span(self, N: int):
        """(rows per member, first row, end row) of this process's members
        for N input rows: rows ``[first * per, (first + n_local) * per)``
        of the padded input, clipped to the N real ones."""
        per = -(-N // self.n_shards)
        first, n_local = self.mesh.first, self.mesh.n_local
        return per, min(first * per, N), min((first + n_local) * per, N)

    def _local_rows(self, a, N: int):
        """This process's real rows of an [N, ...] array or tensor (all of
        them on a one-process mesh)."""
        if self.mesh.group is None:
            return a
        _, lo, hi = self._row_span(N)
        return a[lo:hi]

    def _pad_rows(self, arrays, n_rows: int | None = None):
        """Pad dim 0 of each tensor -- this process's real rows of an
        ``n_rows``-row input (default: the tensors' own rows, the whole
        input of a one-process mesh) -- to its members' ``n_local * per``
        rows with zeros, on its device; returns (padded tensors, rows per
        member, [n_local * per] f32 sample weights: 1 on the real rows, 0
        on the padding)."""
        real = arrays[0].shape[0]
        N = real if n_rows is None else n_rows
        per = -(-N // self.n_shards)
        rows = per * self.mesh.n_local
        pad = rows - real
        sw = torch.ones(rows, dtype=torch.float32, device=self.device)
        if pad:
            arrays = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                      for a in arrays]
            sw[real:] = 0.0
        return arrays, per, sw

    def _gather_rows(self, t):
        """Every member's rows of a per-process tensor ``[n_local * per,
        ...]``, in rank order, on every rank: ``[n * per, ...]`` (the
        tensor itself on a one-process mesh)."""
        if self.mesh.group is None:
            return t
        from ytk_mp4j_tpu_torch.comm.distributed import all_gather_rows

        g = all_gather_rows(t, self.mesh.group)
        return g.reshape((-1,) + tuple(t.shape[1:]))

    def _members(self, arrays, per: int):
        """[n * per, ...] tensors as member tensors [n, per, ...]."""
        n = self.n_shards
        return tuple(a.reshape((n, per) + tuple(a.shape[1:]))
                     for a in arrays)

    def _stream_fit(self, batches, stage_chunk, dispatch,
                    batch_rows: int | None, max_in_flight: int):
        """The double-buffered streaming loop of the FM and linear
        ``fit_stream``: step k is queued on the device, then chunk k + 1
        is staged while the device runs it, with at most
        ``max_in_flight`` steps queued (the host waits on the CUDA event
        recorded after step k - max_in_flight; 0 runs the steps one
        after another). Losses are fetched once, at the end.

        ``stage_chunk(chunk, batch_rows) -> (staged, batch_rows)`` does
        the host half (validate, pad, copy to the device; it resolves
        batch_rows from the first chunk); ``dispatch(staged) -> loss``
        queues the step, carrying the trainer's state in its closure.
        Returns the per-chunk losses as a numpy array."""
        if batch_rows is not None:
            # the padded batch splits evenly over the members
            batch_rows = -(-batch_rows // self.n_shards) * self.n_shards
        losses: list = []
        events: list = []
        staged = None
        for chunk in batches:
            if staged is not None:      # the device runs step k - 1
                losses.append(dispatch(staged))
                events.append(self._record())
                if len(events) > max_in_flight:
                    self._wait(events[-1 - max_in_flight])
                    del events[: len(events) - max_in_flight]
            staged, batch_rows = stage_chunk(chunk, batch_rows)
        if staged is not None:
            losses.append(dispatch(staged))
        if not losses:
            return np.zeros(0, np.float32)
        return torch.stack(losses).cpu().numpy()

    def _record(self):
        """A CUDA event after the work queued so far (None on the
        CPU, where every step has run when it returns)."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            event.synchronize()

    def _pad_stream_rows(self, arrays, batch_rows: int):
        """Pad dim 0 of each chunk tensor up to ``batch_rows`` (raising
        when the chunk is larger) with zeros, on its device; returns
        (padded tensors, [batch_rows] f32 sample weights -- 0 on the
        padding -- and rows per member)."""
        N = arrays[0].shape[0]
        if N > batch_rows:
            raise Mp4jError(
                f"chunk of {N} rows exceeds batch_rows={batch_rows}; "
                "raise batch_rows or shrink the reader's chunk size")
        pad = batch_rows - N
        sw = torch.ones(batch_rows, dtype=torch.float32, device=self.device)
        if pad:
            arrays = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                      for a in arrays]
            sw[N:] = 0.0
        return arrays, sw, batch_rows // self.n_shards

    def _weights(self, sample_weight, N: int):
        """Validated [N] instance weights (see :meth:`_stage_weights`):
        this process's real rows of them, as a tensor on the device."""
        w = self._stage_weights(as_numpy(sample_weight), N)
        return torch.from_numpy(self._local_rows(w, N)).to(self.device)

    def save_params(self, path: str, params) -> None:
        """Persist a flat tuple of parameters (tensors or arrays) and
        the trainer's config as an .npz in the reference's format (keys
        ``p_0``, ``p_1``, ...): each package loads the other's file."""
        save_npz(path, self.cfg,
                 {f"p_{i}": as_numpy(p) for i, p in enumerate(params)})

    @staticmethod
    def load_params(path: str, config_cls):
        """(config, tuple of numpy parameters) from a file of
        :meth:`save_params` (either package's)."""
        cfg, arrays = load_npz(path, config_cls)
        return cfg, tuple(arrays[f"p_{i}"] for i in range(len(arrays)))

    @staticmethod
    def _stage_weights(sample_weight, N: int):
        """Validate optional [N] instance weights; returns 1.0 when
        absent. NaN/negative weights would corrupt the weighted sums
        SILENTLY (NaN losses, or sign-flipped gradients), and an
        all-zero vector trains nothing. Individual zeros are fine (a
        zero weight excludes the row)."""
        if sample_weight is None:
            return np.float32(1.0)
        sw = np.asarray(sample_weight, np.float32)
        if sw.shape != (N,):
            raise Mp4jError(
                f"sample_weight must be [N={N}], got {sw.shape}")
        if not np.isfinite(sw).all() or (sw < 0).any():
            raise Mp4jError(
                "sample_weight must be finite and non-negative")
        if N and not (sw > 0).any():
            raise Mp4jError(
                "sample_weight sums to zero: nothing to train on")
        return sw
