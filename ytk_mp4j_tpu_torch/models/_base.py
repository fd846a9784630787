"""Trainer plumbing shared by the model families (the part of
``ytk_mp4j_tpu/models/_base.py`` the GBDT slices need): a trainer over
a mesh of members (``device.make_mesh`` / ``make_hier_mesh``), rows
padded to a multiple of the member count with zero-weight padding, and
``.npz`` model persistence in the reference's format.

Member m's shard is rows ``[m * per, (m + 1) * per)`` of one contiguous
tensor on the mesh's device (the reference's ``_put_sharded:327``).

Not here yet: ``StepStatsExchanger`` and the ``comm=`` argument that
feeds it (they need the host map plane, ROADMAP queue 1 items 7 and 12).
``save_npz`` writes unconditionally: the port is one process, so the
reference's ``jax.process_index()`` gate has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_mesh
from ytk_mp4j_tpu_torch.exceptions import Mp4jError


def per_example_loss(z, y, loss: str):
    """Per-example data loss on tensors.

    ``logistic``: softplus-form logloss on {0, 1} labels, written as
    ``max(z, 0) - z y + log1p(exp(-|z|))`` for overflow-free evaluation
    at large |z|. ``squared``: 0.5 (z - y)^2. ``softmax``: cross entropy
    over ``z`` [N, C] with integer labels ``y``.
    """
    if loss == "logistic":
        return (torch.clamp(z, min=0) - z * y
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


def save_npz(path: str, cfg, arrays: dict) -> None:
    """Model-persistence writer: the config dataclass (repr of asdict,
    decoded by literal_eval) plus named arrays. Writes through a file
    object so the exact user path is honored (np.savez(path) silently
    appends ".npz")."""
    from dataclasses import asdict

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

    def __init__(self, mesh=None, n_devices=None, device=None):
        if mesh is None:
            mesh = make_mesh(1 if n_devices is None else n_devices, device)
        elif n_devices is not None or device is not None:
            raise Mp4jError("give a mesh, or n_devices and device, not both")
        self.mesh = mesh
        self.device = mesh.device

    @property
    def n_shards(self) -> int:
        return self.mesh.n

    def _pad_rows(self, arrays):
        """Pad dim 0 of each tensor to a multiple of ``n_shards`` with
        zeros, on its device; returns (padded tensors, rows per member,
        [n * per] f32 sample weights: 1 on the real rows, 0 on the
        padding)."""
        N = arrays[0].shape[0]
        n = self.n_shards
        per = -(-N // n)
        pad = per * n - N
        sw = torch.ones(per * n, dtype=torch.float32, device=self.device)
        if pad:
            arrays = [torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
                      for a in arrays]
            sw[N:] = 0.0
        return arrays, per, sw

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
