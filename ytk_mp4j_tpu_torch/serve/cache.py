"""Hot-key row cache for the serve plane.

A copy of ``ytk_mp4j_tpu/serve/cache.py``, with its imports re-rooted at
the port; it imports nothing of the JAX package.

An LRU of pulled parameter rows keyed by the SAME integer row ids the
``comm/keycodec`` vocabularies carry on the columnar map plane — a
cache hit means one fewer id in the next pull round's key-union, so
under a zipf-ish request mix the steady state is zero collectives per
batch (every hot row resident) and the pull plane only moves tail
keys.

Staleness is a FIRST-CLASS bound, not a hope: every row is stamped
with the model version it was pulled under, and a lookup whose stamp
lags the frontend's live version by more than ``stale_versions`` bumps
is a MISS (counted separately as ``serve/cache_stale``), so the
operator-facing guarantee is "a served row is at most N versions
behind the table" — with the default bound of 0, a version bump
atomically invalidates everything older.

Single-owner by design: only the frontend's dispatch thread touches
the cache (the batcher serializes dispatches), so there is no lock —
adding one here would be the start of a lock-order story the serve
plane doesn't need (mp4j-lint R19/R20 keep it honest).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ytk_mp4j_tpu_torch.exceptions import Mp4jError
from ytk_mp4j_tpu_torch.utils import tuning


class HotKeyCache:
    """LRU of ``{row_id: (version_stamp, row vector)}`` with hit /
    miss / eviction / staleness accounting.

    ``capacity_rows == 0`` disables the cache (every lookup is a miss,
    nothing is retained) — the bench A/B knob, so the amortization
    figure measures batching alone.
    """

    def __init__(self, capacity_rows: int | None = None,
                 stale_versions: int | None = None):
        self.capacity = tuning.serve_cache_rows(capacity_rows)
        self.stale_versions = tuning.serve_stale_versions(stale_versions)
        self._rows: OrderedDict[int, tuple[int, np.ndarray]] = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.stale = 0

    def __len__(self) -> int:
        return len(self._rows)

    def lookup(self, row_id: int, version: int):
        """The cached row vector, or ``None`` on a miss. A resident
        row whose stamp lags ``version`` past the staleness bound is
        dropped and counted BOTH stale and miss — the staleness figure
        explains the miss, it does not replace it."""
        ent = self._rows.get(row_id)
        if ent is None:
            self.misses += 1
            return None
        stamp, row = ent
        if version - stamp > self.stale_versions:
            del self._rows[row_id]
            self.stale += 1
            self.misses += 1
            return None
        self._rows.move_to_end(row_id)
        self.hits += 1
        return row

    def insert(self, row_id: int, row: np.ndarray, version: int) -> None:
        """Stamp + retain a pulled row; evicts the least recently used
        row when full. A no-op at capacity 0."""
        if self.capacity == 0:
            return
        if row_id in self._rows:
            self._rows.move_to_end(row_id)
        self._rows[row_id] = (version, row)
        while len(self._rows) > self.capacity:
            self._rows.popitem(last=False)
            self.evictions += 1

    def hit_rate(self) -> float:
        """Lifetime hit fraction (0.0 before any lookup)."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Counter snapshot for the metrics plane / tests."""
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "stale": self.stale,
                "rows": len(self._rows), "capacity": self.capacity,
                "stale_versions": self.stale_versions,
                "hit_rate": self.hit_rate()}


def validate_version(version: int) -> int:
    """Model versions are monotone non-negative ints — the staleness
    bound's arithmetic depends on it."""
    v = int(version)
    if v < 0:
        raise Mp4jError(f"model version={version} must be >= 0")
    return v
