"""Environment knobs of the port. Only ``overlap_enabled`` (from
``ytk_mp4j_tpu/utils/tuning.py:739``) so far; the rest of the reference's
module comes with the host planes."""

from __future__ import annotations

import os

from ytk_mp4j_tpu_torch.exceptions import Mp4jError


def overlap_enabled() -> bool:
    """Whether the trainer loops overlap each step's host statistics
    exchange with the next step's compute (``MP4J_OVERLAP``); ``0`` or
    unset keeps the blocking per-step exchange. A local wait-point
    strategy: the collectives are the same either way."""
    raw = os.environ.get("MP4J_OVERLAP")
    if raw is None or raw.strip() == "":
        return False
    val = raw.strip()
    if val not in ("0", "1"):
        raise Mp4jError(f"MP4J_OVERLAP={raw!r} must be 0 or 1")
    return val == "1"
