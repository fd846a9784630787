"""mp4j-trail — durable streaming telemetry sink.

A copy of ``ytk_mp4j_tpu/obs/sink.py``, with its imports re-rooted at the
port; it imports nothing of the JAX package.

Every observability plane built so far is a bounded in-memory ring:
the span ring, the metrics registry, the audit
record ring and the recovery event log all keep
only a sliding tail, so a multi-day job's history dies with the
process. This module drains those rings to disk continuously:

- :class:`SinkWriter` runs a background thread per rank that, every
  ``MP4J_SINK_FLUSH_SECS``, takes the DELTA of each source ring
  (non-destructive cursors — ``spans.take_since``,
  ``AuditRing.read_since``, ``RecoveryManager.events_since``, and
  stats/metrics snapshot diffs) and appends it as crc-framed records
  to an append-only **segment file** under
  ``MP4J_SINK_DIR/rank_NNNN/``. The drain never runs on the
  collective hot path; the hot path's only cost is the ring appends
  it already pays.
- Segments rotate at a size derived from the PER-RANK disk budget
  ``MP4J_SINK_BYTES``; when the rank's directory would exceed the
  budget the OLDEST whole segment is evicted, so the job's footprint
  is bounded at ``slave_num * MP4J_SINK_BYTES`` no matter how long it
  runs.
- Torn-tail tolerance: each record is framed ``MAGIC | payload_len |
  crc32(payload) | payload`` and appended frame-wise with unbuffered
  ``write`` calls (rotation/eviction run between frames, so any size
  of backlog streams through under the budget); a ``kill -9``
  mid-write can only tear the frame being written, which the reader
  detects (short read or crc mismatch) and reports as exactly one
  torn tail — every prior record stays readable. No fsync per
  record: the OS page cache survives process death, and only a
  machine crash loses the final interval.

Record framing (little-endian)::

    +------+-------------+--------------+---------------------+
    | b"MJ"| len: uint32 | crc32: uint32| payload (JSON utf-8)|
    +------+-------------+--------------+---------------------+

Record payloads (``{"t": kind, ...}``):

- ``meta``    — first record of every segment: rank, slave_num,
  segment ordinal, wall time (readers learn identity from any
  surviving segment, even after eviction removed the first);
- ``spans``   — a batch of span tuples with ``t0`` converted to WALL
  time (``spans.to_wall``), so cross-rank timelines reconstruct from
  independently launched processes;
- ``stats``   — a ``comm.stats()`` delta since the previous record;
- ``metrics`` — a metrics-registry delta (``metrics.diff_snapshot``);
- ``audit``   — a batch of audit digest records (capture payloads
  excluded — the sink is telemetry, the bundle carries bytes);
- ``recovery``— a batch of recovery events, plus this rank's epoch;
- ``alerts``  — a batch of health-plane alert events:
  per-rank verdict transitions and straggler onsets the master pushed
  to this rank, each with an id/wall/detector/from/to — the durable
  half of the ``mp4j-scope health`` timeline.

The offline half — :func:`iter_segment`, :func:`read_rank`,
:func:`load_job` — feeds :mod:`ytk_mp4j_tpu_torch.obs.critpath` (the
``mp4j-scope analyze`` / ``tail`` commands). Deliberately imports
nothing from ``comm`` (the obs discipline); the writer receives its
sources as objects.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

from ytk_mp4j_tpu_torch.obs import metrics as metrics_mod
from ytk_mp4j_tpu_torch.obs import spans
from ytk_mp4j_tpu_torch.utils import stats as stats_mod
from ytk_mp4j_tpu_torch.utils import tuning

MAGIC = b"MJ"
_HEADER = struct.Struct("<2sII")          # magic, payload len, crc32
# one record's payload can never legitimately exceed this — a larger
# length field in a segment means the header itself is corrupt, and
# the reader must not allocate gigabytes chasing it
MAX_RECORD_BYTES = 16 * 1024 * 1024
# spans per "spans" record: the one unbounded batch a drain can form
# (a full default ring is 65536 entries; everything else is bounded
# by its own ring/table size). 4096 spans x ~300 B JSON each keeps
# every frame far below MAX_RECORD_BYTES — a frame the writer emits
# must NEVER look like a corrupt header to the reader, which would
# discard the rest of the segment, not one record
_SPAN_BATCH = 4096
_SEG_FMT = "seg_{:08d}.mp4j"
_SEG_MIN = 64 * 1024


def rank_dir(root: str, rank: int) -> str:
    return os.path.join(root, f"rank_{rank:04d}")


def encode_record(obj: dict) -> bytes:
    """One crc-framed record. JSON payload: self-describing, and torn
    bytes can never masquerade as a record (the crc covers every
    payload byte, the magic pins the frame start). ``default=repr``:
    an exotic object that leaked into span args or an audit record
    must degrade to its repr, never kill the drain thread with a
    TypeError."""
    payload = json.dumps(obj, separators=(",", ":"),
                         default=repr).encode("utf-8")
    return _HEADER.pack(MAGIC, len(payload),
                        zlib.crc32(payload)) + payload


def _write_all(fh, buf: bytes) -> None:
    """Write every byte or raise. An unbuffered FileIO's ``write``
    issues ONE ``write(2)`` and may return short (nearly-full disk,
    RLIMIT_FSIZE) WITHOUT raising — booking a short write as durable
    would count torn records as safe and let later frames land after
    the corrupt bytes, where the reader discards them at the tear."""
    # mp4j-lint: disable=R13 (callers pass plain bytes frames — contiguous by construction)
    view = memoryview(buf)
    while view:
        n = fh.write(view)
        if not n:
            raise OSError("short write: 0 bytes accepted")
        view = view[n:]


def _record_count(rec: dict) -> int:
    """How many underlying telemetry records one frame carries — the
    unit drop accounting uses everywhere (a spans frame batches
    thousands; counting frames would under-report losses by orders of
    magnitude)."""
    kind = rec.get("t")
    if kind == "spans":
        return len(rec.get("spans") or ()) or 1
    if kind == "audit":
        return len(rec.get("records") or ()) or 1
    if kind == "recovery":
        return len(rec.get("events") or ()) or 1
    if kind == "alerts":
        return len(rec.get("alerts") or ()) or 1
    return 1


def iter_segment(path: str, offset: int = 0):
    """Yield ``(record, next_offset)`` from a segment file starting at
    ``offset``; stops at EOF or at a torn tail. Returns via
    StopIteration value — use :func:`read_segment` for the plain
    ``(records, end_offset, torn)`` shape."""
    with open(path, "rb") as fh:
        fh.seek(offset)
        while True:
            start = fh.tell()
            head = fh.read(_HEADER.size)
            if not head:
                return (start, False)        # clean end
            if len(head) < _HEADER.size:
                return (start, True)         # torn header
            magic, length, crc = _HEADER.unpack(head)
            if magic != MAGIC or length > MAX_RECORD_BYTES:
                return (start, True)         # torn/corrupt header
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return (start, True)         # torn payload
            try:
                rec = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                return (start, True)         # crc passed, JSON didn't:
                # treat as torn rather than crash the reader
            yield rec, fh.tell()


def read_segment(path: str, offset: int = 0
                 ) -> tuple[list[dict], int, bool]:
    """``(records, end_offset, torn)`` — every intact record from
    ``offset`` on; ``torn`` is True when the file ends inside a frame
    (exactly one torn tail by construction: the reader stops there).
    ``end_offset`` is where the LAST intact record ended — a follow-
    mode reader resumes from it, so a tail torn only because the
    writer is mid-append completes on the next poll."""
    records: list[dict] = []
    it = iter_segment(path, offset)
    end = offset
    while True:
        try:
            rec, end = next(it)
        except StopIteration as stop:
            pos, torn = stop.value
            if not torn:
                end = pos        # clean EOF; torn keeps the last
                # intact record's end so follow mode re-reads the
                # (possibly still-growing) tail next poll
            return records, end, torn
        records.append(rec)


def list_segments(rdir: str) -> list[str]:
    """Segment paths in a rank dir, oldest first (eviction may have
    removed a prefix — gaps are normal)."""
    try:
        names = sorted(n for n in os.listdir(rdir)
                       if n.startswith("seg_") and n.endswith(".mp4j"))
    except OSError:
        return []
    return [os.path.join(rdir, n) for n in names]


def read_dir(rdir: str) -> dict:
    """Every intact record across ONE directory of crc-framed
    segments, oldest first: ``{"records": [...], "segments": int,
    "torn": int, "bytes": int}``. A torn tail in a NON-final segment
    (the writer crashed, restarted and rotated) is counted too — each
    segment is independent. The generic reader: per-rank sink dirs
    (:func:`read_rank`) and the fleet history dir
    (:mod:`ytk_mp4j_tpu_torch.obs.fleet`) are both plain segment
    directories under this framing."""
    records: list[dict] = []
    torn = 0
    nbytes = 0
    segs = list_segments(rdir)
    for p in segs:
        try:
            recs, end, t = read_segment(p)
        except OSError:
            continue        # evicted under the reader (follow mode)
        # already-parsed records are kept even if the file vanishes
        # (eviction racing a follow-mode reader) before the size
        # stat — megabytes of intact telemetry must not disappear
        # from one analysis pass over a stat on a gone path
        records.extend(recs)
        torn += bool(t)
        try:
            nbytes += os.path.getsize(p)
        except OSError:
            nbytes += end
    return {"records": records, "segments": len(segs), "torn": torn,
            "bytes": nbytes}


def read_rank(rdir: str) -> dict:
    """One rank's sink history — a rank dir IS a plain segment dir
    (kept as its own name: every analyzer call site reads as
    per-rank, and the fleet reader must not look like it reads
    ranks)."""
    return read_dir(rdir)


def load_job(root: str) -> dict[int, dict]:
    """``{rank: read_rank(...)}`` for every ``rank_*/`` under the sink
    root — the analyzer's input."""
    out: dict[int, dict] = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        if not name.startswith("rank_"):
            continue
        try:
            rank = int(name[len("rank_"):])
        except ValueError:
            continue
        d = os.path.join(root, name)
        if os.path.isdir(d):
            out[rank] = read_rank(d)
    return out


class SinkWriter:
    """Per-rank durable sink: background drain of the telemetry rings
    into rotating crc-framed segments (module docstring).

    ``stats`` is the slave's ``CommStats`` (spans are read from the
    process-global ring filtered by this rank — thread-backed
    multi-slave processes share it); ``audit`` / ``recovery`` may be
    None. ``metrics`` defaults to ``stats.metrics``: the sink books
    its own counters (``sink/bytes``, ``sink/records``,
    ``sink/dropped_records``) and the ``sink/lag_secs`` gauge there,
    so sink health rides the existing heartbeat to Prometheus.

    Thread-safety: ``flush()`` may be called from the collective
    thread (close, terminal hook) concurrently with the drain thread;
    ``_io_lock`` serializes whole drains. Everything is best-effort:
    a full disk degrades to dropped telemetry (counted), never to a
    failed collective.
    """

    def __init__(self, root: str, rank: int, *, slave_num: int = 0,
                 stats=None, audit=None, recovery=None, metrics=None,
                 alerts=None, budget_bytes: int | None = None,
                 flush_secs: float | None = None):
        self.root = str(root)
        self.rank = int(rank)
        self.slave_num = int(slave_num)
        self.dir = rank_dir(self.root, self.rank)
        self._stats = stats
        self._audit = audit
        self._recovery = recovery
        # health-alert log: same cursor-delta contract as
        # the audit ring and recovery event log
        self._alerts = alerts
        self._metrics = metrics if metrics is not None else (
            stats.metrics if stats is not None else None)
        self.budget = (tuning.sink_bytes() if budget_bytes is None
                       else int(budget_bytes))
        # segment size: budget/8 keeps eviction granularity fine
        # enough that the budget overshoot is bounded by one segment
        self.seg_bytes = max(_SEG_MIN, self.budget // 8)
        self.flush_secs = (tuning.sink_flush_secs() if flush_secs is None
                           else float(flush_secs))
        self._io_lock = threading.Lock()
        self._fh = None
        self._seg_index = 0
        self._seg_size = 0
        self._seg_records: dict[str, int] = {}   # basename -> size
        # delta cursors into the source rings. The span ring is
        # process-global (thread-backed multi-slave processes share
        # it): start at its oldest still-served cursor so history
        # that predates this writer is neither replayed nor reported
        # as dropped
        self._span_cur = spans.oldest_cursor()
        self._audit_cur = 0
        self._rec_cur = 0
        self._alert_cur = 0
        self._last_stats: dict = {}
        self._last_metrics: dict = {}
        self._last_drain = time.monotonic()
        # lifetime counters (mirrored into the metrics registry)
        self.bytes_written = 0
        self.records_written = 0
        self.dropped_records = 0       # ring overflow before a drain
        self.evicted_segments = 0
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._failed = False

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "SinkWriter":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mp4j-sink-r{self.rank}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_secs):
            self.flush()

    def flush(self) -> None:
        """One synchronous drain of every source ring (the fatal-path
        and close-path entry point; also the drain thread's body).
        Never raises: an unexpected exception (not just OSError) is
        counted and remembered instead of killing the drain thread —
        a silently dead sink whose counters freeze at plausible
        values is exactly the healthy-looking-dead state this plane
        exists to prevent."""
        try:
            with self._io_lock:
                self._drain_locked()
        except Exception as e:          # noqa: BLE001 - see docstring
            with self._io_lock:
                self.dropped_records += 1
                self.last_error = repr(e)
            if self._metrics is not None and self._metrics.enabled:
                self._metrics.inc("sink/dropped_records", 1)

    def abort(self) -> None:
        """Stop draining WITHOUT a final flush — the fault-injected
        ``kill`` path: a crashed process flushes nothing, and the
        simulation must not keep writing segments a real corpse
        couldn't."""
        self._stop.set()
        with self._io_lock:
            self._failed = True
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def close(self) -> None:
        """Stop the drain thread, final flush, release the segment.
        The final drain rides :meth:`flush` so its catch-all applies —
        a poison record in the last interval must not turn a clean
        job shutdown into an uncaught exception."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        self.flush()
        with self._io_lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- the drain ------------------------------------------------------
    def _drain_locked(self) -> None:
        if self._failed:
            return
        now = time.monotonic()
        lag = now - self._last_drain
        recs: list[dict] = []
        dropped = 0

        self._span_cur, items, d = spans.take_since(self._span_cur)
        dropped += d
        mine = [s for s in items if s[4] == self.rank]
        for i in range(0, len(mine), _SPAN_BATCH):
            recs.append({"t": "spans", "spans": [
                [s[0], s[1], round(spans.to_wall(s[2]), 6),
                 round(s[3], 9), s[4], s[5], s[6]]
                for s in mine[i:i + _SPAN_BATCH]]})

        if self._stats is not None:
            snap = self._stats.snapshot()
            sd = stats_mod.diff_snapshots(snap, self._last_stats)
            self._last_stats = snap
            if sd:
                recs.append({"t": "stats", "delta": sd})
        if self._metrics is not None:
            msnap = self._metrics.snapshot()
            md = metrics_mod.diff_snapshot(msnap, self._last_metrics)
            self._last_metrics = msnap
            # the sink's OWN accounting (sink/*) is excluded from the
            # stream: writing it would change the counters, making the
            # next delta non-empty forever — an idle job would churn
            # one self-accounting frame per flush interval and evict
            # its real collective history to store sink noise. Sink
            # health reaches Prometheus via the heartbeat and the
            # postmortem via sink.json; segments carry the job.
            counters = {k: v for k, v in md.get("counters", {}).items()
                        if not k.startswith("sink/")}
            gauges = {k: v for k, v in md.get("gauges", {}).items()
                      if not k.startswith("sink/")}
            if counters or md.get("histograms"):
                recs.append({"t": "metrics", "delta": {
                    "counters": counters, "gauges": gauges,
                    "histograms": md.get("histograms", {})}})

        if self._audit is not None:
            self._audit_cur, arecs, d = self._audit.read_since(
                self._audit_cur)
            dropped += d
            if arecs:
                recs.append({"t": "audit", "records": arecs})
        if self._recovery is not None:
            self._rec_cur, events, d = self._recovery.events_since(
                self._rec_cur)
            dropped += d
            if events:
                recs.append({"t": "recovery",
                             "epoch": self._recovery.epoch,
                             "events": [[round(ts, 6), kind, detail]
                                        for ts, kind, detail in events]})
        if self._alerts is not None:
            self._alert_cur, evs, d = self._alerts.events_since(
                self._alert_cur)
            dropped += d
            if evs:
                recs.append({"t": "alerts", "alerts": evs})
        if recs:
            try:
                dropped += self._write_records(recs)
            except Exception as e:      # noqa: BLE001 - encode-side
                # poison (e.g. a CYCLIC structure in span args —
                # default=repr only saves acyclic oddities). Encoding
                # happens before any write, so the whole delta is
                # lost: count it in RECORD units, remember the error,
                # never let telemetry fail the job
                dropped += sum(_record_count(r) for r in recs)
                self.last_error = repr(e)
                try:
                    if self._fh is not None:
                        self._fh.close()
                except OSError:
                    pass
                self._fh = None
        if dropped:
            self.dropped_records += dropped
            if self._metrics is not None and self._metrics.enabled:
                self._metrics.inc("sink/dropped_records", dropped)
        self._note_metrics(lag)
        self._last_drain = now

    def _note_metrics(self, lag: float) -> None:
        m = self._metrics
        if m is None or not m.enabled:
            return
        m.set_gauge("sink/lag_secs", round(lag, 3))
        m.set_gauge("sink/dir_bytes", float(sum(
            self._seg_records.values())))

    def _write_records(self, recs: list[dict]) -> int:
        """Append the drain's records FRAME BY FRAME: rotation and
        eviction run between frames, so an arbitrarily large backlog
        (a stalled drain thread, a burst of collectives) streams
        through many segments under the budget instead of landing as
        one oversized write that blows past it — "the directory never
        exceeds MP4J_SINK_BYTES" must hold for any drain size. Span
        records too big for half a segment split recursively first. A
        kill -9 still tears at most the single frame being written.

        Returns the RECORD count lost (unsplittable-oversized frames
        plus everything after a write failure). A full/unwritable
        disk must never fail the job — and must never double-count:
        frames durably written before the failing one stay counted as
        written, only the unwritten remainder reports as dropped."""
        frames: list[tuple[bytes, int]] = []
        half_seg = max(4096, self.seg_bytes // 2)
        lost = 0
        for rec in recs:
            lost += self._encode_bounded(rec, half_seg, frames)
        for i, (frame, count) in enumerate(frames):
            try:
                fh = self._ensure_segment(len(frame))
                _write_all(fh, frame)
            except OSError as e:
                self.last_error = repr(e)
                try:
                    if self._fh is not None:
                        self._fh.close()
                except OSError:
                    pass
                self._fh = None
                return lost + sum(c for _, c in frames[i:])
            self._seg_size += len(frame)
            self._seg_records[os.path.basename(self._seg_path())] = \
                self._seg_size
            self.bytes_written += len(frame)
            self.records_written += count
            m = self._metrics
            if m is not None and m.enabled:
                m.inc("sink/bytes", len(frame))
                m.inc("sink/records", count)
        return lost

    # which key holds each batching record kind's splittable list —
    # audit records and recovery events are exactly as splittable as
    # span batches, and an unsplit oversized batch would defeat the
    # budget bound for small MP4J_SINK_BYTES just the same
    _SPLIT_KEYS = {"spans": "spans", "audit": "records",
                   "recovery": "events", "alerts": "alerts"}

    def _encode_bounded(self, rec: dict, cap: int,
                        out: list[tuple[bytes, int]]) -> int:
        """Encode ``rec``, splitting batch records (spans/audit/
        recovery lists) in half until each frame fits ``cap``; returns
        the record count DROPPED (an unsplittable oversized record —
        one giant span, a huge metrics table: a frame above the
        reader's limits would read as a corrupt header and take the
        rest of its segment along). The caller folds the return into
        the drain's drop accounting so the metric and the ``!`` live
        marker see it like every other loss."""
        frame = encode_record(rec)
        if len(frame) <= min(cap, MAX_RECORD_BYTES):
            out.append((frame, _record_count(rec)))
            return 0
        key = self._SPLIT_KEYS.get(rec.get("t"))
        items = rec.get(key) if key else None
        if items and len(items) > 1:
            mid = len(items) // 2
            lo = {**rec, key: items[:mid]}
            hi = {**rec, key: items[mid:]}
            return (self._encode_bounded(lo, cap, out)
                    + self._encode_bounded(hi, cap, out))
        if len(frame) <= MAX_RECORD_BYTES:
            out.append((frame, _record_count(rec)))   # over the soft
            # cap but still readable: better a fat segment than loss
            return 0
        return _record_count(rec)

    def _seg_path(self) -> str:
        return os.path.join(self.dir, _SEG_FMT.format(self._seg_index))

    def _ensure_segment(self, incoming: int):
        """The open segment file, rotating + evicting as needed."""
        if self._fh is not None and self._seg_size + incoming \
                > self.seg_bytes:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
        if self._fh is None:
            os.makedirs(self.dir, exist_ok=True)
            # resume after restart/rotation: next index past anything
            # already on disk (scanned once, then tracked in memory)
            if not self._seg_records:
                for p in list_segments(self.dir):
                    base = os.path.basename(p)
                    try:
                        self._seg_records[base] = os.path.getsize(p)
                        idx = int(base[len("seg_"):-len(".mp4j")])
                        self._seg_index = max(self._seg_index, idx + 1)
                    except (OSError, ValueError):
                        continue
            else:
                self._seg_index += 1
            self._evict(incoming)
            # unbuffered append-only segment write — the ONE sanctioned
            # non-atomic write path (mp4j-lint R14 baseline): frames
            # are crc-delimited and the reader tolerates a torn tail
            self._fh = open(self._seg_path(), "ab", buffering=0)
            self._seg_size = 0
            head = encode_record({
                "t": "meta", "rank": self.rank,
                "slave_num": self.slave_num, "seg": self._seg_index,
                # wall clock: segment identity must be human-meaningful
                # across hosts, like the postmortem bundle's timestamp
                # mp4j-lint: disable=R11 (artifact timestamp, not a duration)
                "wall": time.time(),
                "budget": self.budget, "seg_bytes": self.seg_bytes})
            _write_all(self._fh, head)
            self._seg_size += len(head)
            self._seg_records[os.path.basename(self._seg_path())] = \
                self._seg_size
        return self._fh

    def _evict(self, incoming: int) -> None:
        """Drop oldest whole segments until the budget holds (never
        the active one — the writer is about to append there). A full
        segment of headroom stays reserved for the active file's
        growth, so the directory never exceeds the budget even
        BETWEEN rotations — the acceptance bound is "disk never
        exceeds MP4J_SINK_BYTES", not "returns under it each
        rotation"."""
        target = max(self.seg_bytes, self.budget - self.seg_bytes)
        total = sum(self._seg_records.values()) + incoming
        active = os.path.basename(self._seg_path())
        for base in sorted(self._seg_records):
            if total <= target:
                break
            if base == active:
                break
            try:
                os.remove(os.path.join(self.dir, base))
            except OSError:
                # the file is still on disk: keep it in the
                # accounting (forgetting it would undercount every
                # later budget check and silently break the bound
                # forever) and stop — if the oldest can't go, newer
                # ones likely can't either; retry next rotation
                break
            total -= self._seg_records.pop(base)
            self.evicted_segments += 1

    def status(self) -> dict:
        """One sink-health record (postmortem bundle's ``sink.json``,
        the master's manifest). Counters are written by the drain
        thread under ``_io_lock`` — snapshot under the same lock so a
        status render never shows a half-applied flush."""
        with self._io_lock:
            return {"dir": self.dir, "root": self.root,
                    "bytes_written": self.bytes_written,
                    "records_written": self.records_written,
                    "dropped_records": self.dropped_records,
                    "evicted_segments": self.evicted_segments,
                    "last_error": self.last_error,
                    "budget_bytes": self.budget,
                    "segment_bytes": self.seg_bytes}
