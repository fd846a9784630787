"""Bounded span ring + Chrome-trace export.

A copy of ``ytk_mp4j_tpu/obs/spans.py``, with its imports re-rooted at the
port; it imports nothing of the JAX package.

Every phase event the always-on :class:`~ytk_mp4j_tpu_torch.utils.stats.
CommStats` books (wire/reduce/serialize, at chunk granularity) and
every outermost collective call the ``trace.traced`` wrapper times is
also appended here as a *span*: ``(name, category, start, duration,
rank, thread, args)``. The ring is bounded (``MP4J_SPAN_RING`` entries,
default 65536; 0 disables) so a long job keeps a sliding window of the
most recent activity at a fixed memory cost, and appending is one
O(1) ``deque.append`` — cheap enough to stay default-on.

:func:`export_chrome_trace` renders the ring as trace-event JSON
(``{"traceEvents": [...]}``, complete-event ``"ph": "X"`` records with
``ts``/``dur`` in microseconds, ``pid`` = mp4j rank, ``tid`` = a small
per-process thread id), loadable in ``chrome://tracing`` or Perfetto.
Multi-process jobs export one file per rank; ``mp4j-scope merge``
combines them into a single timeline (ranks keep distinct pids).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any

from ytk_mp4j_tpu_torch.utils import tuning

_lock = threading.Lock()
# Trace timebase: spans are recorded in perf_counter time (cheap,
# monotone) but EXPORTED anchored to the wall clock — perf_counter
# epochs are per-process, so independently launched ranks would
# otherwise shift by their launch skew in a merged timeline. Residual
# cross-host skew is whatever NTP leaves (ms-scale), fine for eyeballs.
_epoch = time.perf_counter()
_epoch_wall = time.time()
_capacity = tuning.span_ring_capacity()
_ring: collections.deque = collections.deque(maxlen=max(_capacity, 1))
_enabled = _capacity > 0
_tids: dict[int, int] = {}        # thread ident -> small stable tid
# total spans ever appended — the durable sink's delta cursor:
# take_since(cursor) derives (new records, ring-overflow drops)
# from (count, ring length, cursor) alone, so readers never consume
# the ring. Appends bump it under _lock so (ring, count) stay
# consistent for the cursor math.
_count = 0


def enabled() -> bool:
    return _enabled


def configure(capacity: int) -> None:
    """Resize (and clear) the ring; 0 disables recording. Mainly for
    tests and embedding applications — jobs configure via
    ``MP4J_SPAN_RING``."""
    global _ring, _capacity, _enabled
    with _lock:
        _capacity = capacity
        _enabled = capacity > 0
        _ring = collections.deque(maxlen=max(capacity, 1))


def clear() -> None:
    with _lock:
        _ring.clear()


def _append(item: tuple) -> None:
    global _count
    with _lock:
        _ring.append(item)
        _count += 1


def ring_delta(ring, count: int, cursor: int
               ) -> tuple[int, list, int]:
    """``(count, new_items, dropped)`` — THE cursor-delta read every
    bounded-ring source shares (span ring here, the audit record ring,
    the recovery event log): items appended since ``cursor`` that are
    still in the ring, plus how many already fell off (reported, never
    silently lost). A cursor ahead of ``count`` (ring reconfigured/
    cleared) resets cleanly. The caller holds its own lock.

    Cost is O(new items), not O(ring): reversed(deque) iterates from
    the right, so a near-current reader over a full 65536-entry ring
    copies only its delta — appenders sharing the caller's lock must
    never stall behind a full-ring copy."""
    new = count - min(cursor, count)
    avail = min(new, len(ring))
    if not avail:
        return count, [], new
    items = list(itertools.islice(reversed(ring), avail))
    items.reverse()
    return count, items, new - avail


def take_since(cursor: int) -> tuple[int, list[tuple], int]:
    """``(new_cursor, spans, dropped)`` — every span appended since
    ``cursor`` that is still in the ring (:func:`ring_delta` under the
    span lock). Non-destructive: any number of readers keep
    independent cursors."""
    with _lock:
        return ring_delta(_ring, _count, cursor)


def oldest_cursor() -> int:
    """The earliest cursor :func:`take_since` can still serve in full
    — a reader attaching mid-process (the durable sink of a slave
    constructed after other slaves already ran in this process)
    starts here so pre-attachment history is neither replayed nor
    misreported as dropped."""
    with _lock:
        return _count - len(_ring)


def to_wall(t0: float) -> float:
    """A span's ``perf_counter`` timestamp anchored to the wall clock
    — the same anchoring :func:`export_chrome_trace` applies, shared
    so the durable sink writes cross-rank-comparable timestamps."""
    return t0 - _epoch + _epoch_wall


def _tid() -> int:
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        with _lock:
            tid = _tids.setdefault(ident, len(_tids))
    return tid


def record(name: str, cat: str, t0: float, dur: float,
           pid: int | None, args: dict[str, Any] | None = None) -> None:
    """Append one complete span (``t0`` in ``time.perf_counter``
    seconds). Bounded ring: the oldest span falls off when full."""
    if not _enabled:
        return
    _append((name, cat, t0, dur, pid or 0, _tid(), args))


def phase(name: str, seconds: float, pid: int | None, collective: str,
          seq: int, **extra) -> None:
    """A phase span (wire/reduce/serialize) booked after the fact: the
    caller measured ``seconds`` ending now, so the span's start is
    reconstructed as ``now - seconds``."""
    if not _enabled:
        return
    end = time.perf_counter()
    args: dict[str, Any] = {"collective": collective, "seq": seq}
    for k, v in extra.items():
        if v is not None:
            args[k] = v
    _append((name, "phase", end - seconds, seconds, pid or 0,
             _tid(), args))


def mark(name: str, pid: int | None, **args: Any) -> None:
    """A zero-duration recovery event (abort announced, retry started,
    terminal abort) — renders as an instant tick on the rank's
    timeline, so ``mp4j-scope`` traces show exactly where a job
    recovered."""
    if not _enabled:
        return
    _append((name, "recovery", time.perf_counter(), 0.0, pid or 0,
             _tid(), {k: v for k, v in args.items()
                      if v is not None} or None))


def collective(name: str, t0: float, dur: float, pid: int | None,
               seq: int) -> None:
    """The outermost collective-call span (emitted by trace.traced)."""
    if not _enabled:
        return
    _append((name, "collective", t0, dur, pid or 0, _tid(),
             {"seq": seq}))


def snapshot() -> list[tuple]:
    with _lock:
        return list(_ring)


def export_chrome_trace(path: str) -> int:
    """Write the ring as trace-event JSON; returns the event count.

    Events are globally sorted by start time, so ``ts`` is monotone
    non-decreasing on every (pid, tid) track — the invariant the tier-1
    schema test asserts and Perfetto's importer expects.
    """
    events = []
    for name, cat, t0, dur, pid, tid, args in sorted(
            snapshot(), key=lambda s: s[2]):
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round((t0 - _epoch + _epoch_wall) * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        events.append(ev)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    _atomic_dump(path, doc)
    return len(events)


def _atomic_dump(path: str, doc) -> None:
    """Tmp-file + ``os.replace`` write: a crash mid-dump leaves either
    the previous file or the complete new one, never a syntactically
    truncated JSON masquerading as a trace (mp4j-lint R14)."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)


def merge_chrome_traces(out_path: str, in_paths: list[str]) -> int:
    """Merge per-rank Chrome-trace files into one timeline (ranks keep
    their pids; events re-sorted by ``ts`` so every track stays
    monotone). Accepts both the object form (``{"traceEvents": [...]}``)
    and the bare-array form of the trace-event format."""
    merged: list[dict] = []
    for p in in_paths:
        with open(p, encoding="utf-8") as fh:
            doc = json.load(fh)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        merged.extend(events)
    merged.sort(key=lambda e: (e.get("ts", 0)))
    _atomic_dump(out_path, {"traceEvents": merged,
                            "displayTimeUnit": "ms"})
    return len(merged)
