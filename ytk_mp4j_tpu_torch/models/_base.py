"""Trainer plumbing shared by the model families (the part of
``ytk_mp4j_tpu/models/_base.py`` the one-device GBDT slice needs).

Not here yet: ``StepStatsExchanger`` and the ``comm=`` argument that
feeds it (they need the host comm plane), row padding to shard
multiples (it has no role on one device), and model persistence.
"""

from __future__ import annotations

import numpy as np
import torch

from ytk_mp4j_tpu_torch.device import make_device
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


class DataParallelTrainer:
    """Device bookkeeping shared by the trainers (one device so far)."""

    def __init__(self, device=None):
        self.device = make_device(device)

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
